"""Checkpoint resharding on one card: restore a training checkpoint onto
the device of another run.

  PYTHONPATH=src python -m repro_torch.launch.reshard --arch tinyllama-1.1b \
      --ckpt-dir build/ck [--reduced] [--device cuda|cpu]

Twin of src/repro/launch/reshard.py in its one-card form. The checkpoint
holds full arrays and a manifest (train/checkpoint.py, the reference's
format), so one written by any run, or by the JAX package, restores
onto any device: `load` checks each leaf's crc32 and places it there.
The reference places the leaves on a new mesh with the NamedShardings of
launch/sharding.py. Its twins exist (launch/mesh.py's RankMesh,
launch/sharding.py's rules, and `checkpoint.load(..., mesh=)`, which
gives each rank its slice), but this driver restores onto one device
only: resharding across ranks is ROADMAP.md §1 item 4.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get
from repro_torch.models import api as mapi
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import TrainConfig, abstract_train_state


def reshard_state(arch: str, ckpt_dir: str, *, device="cuda",
                  reduced: bool = False):
    """The training state {"params", "opt"} of `arch` restored from the
    latest checkpoint under ckpt_dir onto `device`. Returns (state,
    step)."""
    cfg = get(arch)
    if reduced:
        cfg = cfg.reduced(dtype="float32", remat=False)
    target = abstract_train_state(mapi.build(cfg), TrainConfig())
    return ckpt.load(target, ckpt_dir, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    state, step = reshard_state(args.arch, args.ckpt_dir, device=args.device,
                                reduced=args.reduced)
    n_leaves = len(ckpt.leaf_names(state))
    print(f"resharded step-{step} checkpoint onto {args.device} "
          f"({n_leaves} arrays)")
    return state, step


if __name__ == "__main__":
    main()
