"""Checkpoints and spills through one ``.npz`` per tree (port of
``repro.fedckpt``; the file layout is the reference's, so either package
loads the other's files)."""
from repro_torch.fedckpt.checkpointer import (  # noqa: F401
    Checkpointer, client_state_path, load_pytree, save_pytree,
    spilled_client_ids,
)
