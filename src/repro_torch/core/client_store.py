"""Per-client state and data access (port of ``repro/core/client_store.py``,
``InMemoryStore`` only: what the sequential engine calls).

The store owns every per-client access of a round: the raw host shard,
its size, and the SCAFFOLD control variates as a dense list over all C
clients.  The spilling store arrives with the robustness slice.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.utils.pytree import tree_map, tree_zeros_like

PyTree = Any


class InMemoryStore:
    """Dense control list over all C clients; ``control_mean`` is the
    reference's ``sum(xs) / len(xs)`` in client order."""

    def __init__(self, task):
        self.task = task
        self._controls: Optional[list[PyTree]] = None

    @property
    def num_clients(self) -> int:
        return len(self.task.client_data)

    def client_shard(self, cid: int):
        """The raw host-side shard."""
        return self.task.client_data[int(cid)]

    def num_examples(self, cid: int) -> int:
        """|X_i| of an (x, y) shard."""
        return len(self.client_shard(cid)[0])

    def init_controls(self, like: PyTree) -> None:
        """SCAFFOLD c_i ≡ 0 at init: one shared zero tree (never written in
        place) until a client's first ``put_control``."""
        zero = tree_zeros_like(like)
        self._controls = [zero for _ in range(self.num_clients)]

    def get_control(self, cid: int) -> PyTree:
        return self._controls[int(cid)]

    def put_control(self, cid: int, c: PyTree) -> None:
        self._controls[int(cid)] = c

    def control_mean(self) -> PyTree:
        """The server control c = mean_i c_i over ALL clients."""
        cs = self._controls
        return tree_map(lambda *xs: sum(xs) / len(xs), *cs)


def make_client_store(cfg, task) -> InMemoryStore:
    """The configured store (``FedConfig.client_store``; validation has
    already refused the unported ``"spilling"``)."""
    return InMemoryStore(task)
