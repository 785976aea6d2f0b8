"""Datacenter training launcher (the port of `repro.launch.train`): train
a zoo architecture with the train step of `repro_torch.launch.steps` on a
mesh (`launch/mesh.py`), the card unless `--device cpu` is given. Used by
examples/satellite_fl_train_torch.py's Part B, and standalone for LM
pretraining smoke runs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --reduced --steps 20 --batch 8 --seq 128

`--mesh host` (the default) is `make_host_mesh()`: one process is a world
of one; under `torchrun --nproc-per-node N` the N ranks train data
parallel with ZeRO-1 (the batch split over them a microbatch at a time),
and only rank 0 prints:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-8b --reduced --steps 20 --batch 8 --seq 128

`--mesh single` and `multi` are the production meshes, which need worlds
of 256 and 512 ranks.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.launch.input_specs import train_batch_specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T


def synthetic_lm_batch(cfg, shape, step, seed=0, device=None):
    """Deterministic synthetic LM batch: structured token streams so loss
    actually decreases (next-token = current + class pattern). The
    reference's numpy draws, bit for bit, as tensors on `device` (the
    card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed * 100_003 + step)
    specs = train_batch_specs(cfg, shape)
    B = shape.global_batch
    out = {}
    if "frames" in specs:
        out["frames"] = rng.normal(0, 1, tuple(specs["frames"].shape)
                                   ).astype(np.float32)
    if "image_embeds" in specs:
        out["image_embeds"] = rng.normal(
            0, 1, tuple(specs["image_embeds"].shape)).astype(np.float32)
    st = specs["tokens"].shape[1]
    # periodic sequences with noise: learnable structure
    base = rng.integers(0, min(cfg.vocab_size, 97), (B, 1))
    pos = np.arange(st)[None, :]
    toks = (base + pos) % min(cfg.vocab_size, 97)
    flip = rng.random((B, st)) < 0.05
    toks = np.where(flip, rng.integers(0, cfg.vocab_size, (B, st)), toks)
    out["tokens"] = toks.astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    out["labels"] = labels.astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def train(arch: str, *, reduced: bool = True, steps: int = 20,
          batch: int = 8, seq: int = 128, lr: float = 3e-4,
          num_micro: int = 1, mesh_kind: str = "host", log_every: int = 5,
          device=None):
    """Train `arch` from `init_params(0, ...)` for `steps` steps of
    `synthetic_lm_batch` on the mesh `mesh_kind` names; prints the
    reference's log line (rank 0 of the mesh alone) and returns the loss
    history. "host" is `launch.mesh.make_host_mesh(device)`: a world of
    one in this process, or the ranks of the group it runs in (under
    `torchrun`: data parallel with ZeRO-1, every rank drawing the same
    params and batches). "single" and "multi" are the production meshes,
    which raise below 256 and 512 ranks. A process group this call starts
    it also ends."""
    dev = resolve_device(device)
    started = not dist.is_initialized()
    mesh = {"host": lambda: make_host_mesh(dev),
            "single": lambda: make_production_mesh(device=dev),
            "multi": lambda: make_production_mesh(True, device=dev),
            }[mesh_kind]()
    try:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        shape = ShapeConfig("custom", seq_len=seq, global_batch=batch,
                            kind="train")
        step_fn = ST.make_train_step(cfg, mesh, num_micro=num_micro,
                                     q_chunk=min(512, seq), lr=lr)
        params = T.init_params(0, cfg, device=dev)
        opt = ST.init_opt_state(params, cfg, mesh)
        lead = dist.get_rank() == 0
        history = []
        for s in range(steps):
            t0 = time.time()
            batch_data = synthetic_lm_batch(cfg, shape, s, device=dev)
            params, opt, metrics = step_fn(params, opt, batch_data)
            loss = float(metrics["loss"])
            history.append(loss)
            if lead and (s % log_every == 0 or s == steps - 1):
                print(f"step {s:4d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({time.time() - t0:.2f}s)", flush=True)
        return history
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--num-micro", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    hist = train(args.arch, reduced=args.reduced, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 num_micro=args.num_micro, mesh_kind=args.mesh,
                 device=args.device)
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f}")


if __name__ == "__main__":
    main()
