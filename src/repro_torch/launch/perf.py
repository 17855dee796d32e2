"""Named, reproducible experiments over the dry run (port of
``repro/launch/perf.py``).

Each experiment counts one (arch × shape) with ONE change against the
baseline dry run (``launch/dryrun.py``) and writes a tagged record beside
it:

  python -m repro_torch.launch.perf --exp decode_splitk
  python -m repro_torch.launch.perf --all

Experiments:
  decode_splitk       qwen decode_32k: the cache sequence sharded over
                      ``model`` instead of heads / dh.
  decode_splitk_llava the same layout for llava-next-mistral-7b.
  train_fsdp          gemma train_4k: params FSDP over ``data`` as well.
  train_noremat       gemma train_4k without recomputation (``remat=False``).
  train_remat_dots    gemma train_4k, recomputing all but the products with
                      no batch dims (``remat="dots"``).
  fedsdd_round        the FedSDD round on the 2-pod mesh (the K groups on
                      the pod axis).
  fedsdd_round_1pod   the same on one pod (both groups on every rank).
"""
from __future__ import annotations

import argparse
import dataclasses
import traceback

from repro_torch.launch.dryrun import DEFAULT_OUT, lower_one, save_rec


def _print(rec):
    if not rec.get("supported", True):
        print(f"SKIP: {rec['skip_reason']}")
        return
    print(f"  flops/chip={rec['flops_per_chip']:.3e}"
          f" hbm={rec['hbm_bytes_per_chip']/1e9:.1f}GB"
          f" coll={rec['collective_bytes_per_chip']/1e9:.2f}GB"
          f" terms=({rec['compute_s']:.3g},{rec['memory_s']:.3g},"
          f"{rec['collective_s']:.3g}) dominant={rec['dominant']}")


EXPERIMENTS = {}


def exp(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        return fn
    return deco


@exp("decode_splitk")
def decode_splitk(out):
    rec = lower_one("qwen2.5-14b", "decode_32k", cache_seq_axis="model",
                    extra_tag="splitk")
    save_rec(rec, out)
    return rec


@exp("decode_splitk_llava")
def decode_splitk_llava(out):
    rec = lower_one("llava-next-mistral-7b", "decode_32k",
                    cache_seq_axis="model", extra_tag="splitk")
    save_rec(rec, out)
    return rec


@exp("train_fsdp")
def train_fsdp(out):
    rec = lower_one(
        "gemma-2b", "train_4k",
        cfg_override=lambda c: dataclasses.replace(c, fsdp=True),
        extra_tag="fsdp")
    save_rec(rec, out)
    return rec


@exp("train_noremat")
def train_noremat(out):
    rec = lower_one("gemma-2b", "train_4k", remat=False,
                    extra_tag="noremat")
    save_rec(rec, out)
    return rec


@exp("train_remat_dots")
def train_remat_dots(out):
    rec = lower_one("gemma-2b", "train_4k", remat="dots",
                    extra_tag="rematdots")
    save_rec(rec, out)
    return rec


@exp("fedsdd_round")
def fedsdd_round(out):
    rec = lower_one("gemma-2b", "train_4k", multi_pod=True, fedsdd=True,
                    spec_overrides=dict(clients_per_group=16, client_batch=1,
                                        server_batch=8))
    save_rec(rec, out)
    return rec


@exp("fedsdd_round_1pod")
def fedsdd_round_1pod(out):
    rec = lower_one("gemma-2b", "train_4k", multi_pod=False, fedsdd=True,
                    spec_overrides=dict(clients_per_group=16, client_batch=1,
                                        server_batch=8))
    save_rec(rec, out)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default=None, choices=sorted(EXPERIMENTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    names = sorted(EXPERIMENTS) if args.all else [args.exp]
    failures = 0
    for n in names:
        print(f"== {n} ==", flush=True)
        try:
            rec = EXPERIMENTS[n](args.out)
            _print(rec)
        except Exception as e:
            failures += 1
            print(f"FAIL {n}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} experiment failures")


if __name__ == "__main__":
    main()
