"""Fault-tolerant LM trainer, as the reference's (``repro.launch.train``):

* auto-resume from the newest valid checkpoint (atomic, keep-k;
  ``checkpoint.CheckpointManager``),
* exact data replay after a restart (the pipeline is a pure function of
  ``(seed, step)``),
* NaN/Inf step rejection (in the train step; skipped steps are counted),
* a heartbeat file and a step deadline for an external watchdog,
* graceful preemption: SIGTERM makes the current step's checkpoint the
  last one; the previous SIGTERM handler is restored when ``train``
  returns.

It runs on the card unless the caller asks for ``device="cpu"``.

Usage:  PYTHONPATH=src python -m repro_torch.launch.train \\
    --arch qwen2.5-3b --smoke --steps 20 --batch 8 --seq 128 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import signal
import time
from pathlib import Path

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import TokenPipeline
from ..device import resolve_device
from .steps import init_train_state, make_train_step


def train(
    arch: str,
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    ckpt_dir: str = "artifacts/ckpt",
    ckpt_every: int = 10,
    seed: int = 0,
    step_deadline_s: float = 600.0,
    microbatches: int = 1,
    log=print,
    device="cuda",
    cfg=None,
):
    """Trains ``arch`` (its ``SMOKE`` config with ``smoke``, else the
    published one; ``cfg`` overrides both) for ``steps`` steps of ``batch`` x
    ``seq`` tokens from ``TokenPipeline(seed)``, resuming from ``ckpt_dir``.
    Returns ``{"losses", "final_state", "skipped", "last_step",
    "step_seconds"}``: the losses and wall seconds of the steps this call
    ran. A step's wall runs from its batch to its host fetch, which waits
    for the previous step's update (its own is queued, not waited for), so
    in the loop it is the period of a step."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    pipeline = TokenPipeline(vocab_size=cfg.vocab_size, batch_size=batch,
                             seq_len=seq, seed=seed)
    step_fn = make_train_step(cfg, total_steps=steps, microbatches=microbatches)

    mgr = CheckpointManager(ckpt_dir, keep=3)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(cfg, gen, dev)

    start_step = 0
    latest = mgr.latest()
    if latest is not None:
        state, manifest = mgr.restore(latest, state)
        start_step = int(manifest["extra"].get("next_step", latest))
        log(f"[train] resumed from checkpoint step={latest} "
            f"(continuing at {start_step})")

    stop = {"flag": False}

    def _sigterm(_sig, _frm):  # preemption: flush and exit cleanly
        stop["flag"] = True

    try:
        previous = signal.signal(signal.SIGTERM, _sigterm)
        installed = True
    except ValueError:  # not the main thread: no handler can be installed
        installed = False
    hb_path = Path(ckpt_dir) / "heartbeat.json"
    losses, step_seconds = [], []
    skipped_total = 0
    step = start_step - 1
    try:
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            batch_np = pipeline.batch_at(step)
            state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                             for k, v in batch_np.items()})
            loss = metrics["loss"]
            skipped_total += metrics["skipped"]
            dt = time.perf_counter() - t0
            losses.append(loss)
            step_seconds.append(dt)

            # heartbeat for the external watchdog (hang/straggler detection)
            hb_path.write_text(json.dumps(
                {"step": step, "time": time.time(), "loss": loss,
                 "deadline_s": step_deadline_s}))
            if dt > step_deadline_s:
                log(f"[train] WARNING step {step} exceeded deadline "
                    f"({dt:.1f}s > {step_deadline_s}s)")

            if (step + 1) % ckpt_every == 0 or step == steps - 1 or stop["flag"]:
                mgr.save(step, state, extra={"next_step": step + 1,
                                             "arch": arch, "seed": seed})
            if stop["flag"]:
                log(f"[train] preempted at step {step}; checkpoint flushed")
                break
            if step % 5 == 0:
                log(f"[train] step={step} loss={loss:.4f} "
                    f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
    finally:
        if installed:  # None: the previous handler was not installed from Python
            signal.signal(signal.SIGTERM, signal.SIG_DFL if previous is None else previous)

    return {"losses": losses, "final_state": state, "skipped": skipped_total,
            "last_step": step, "step_seconds": step_seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                seed=args.seed, microbatches=args.microbatches, device=args.device)
    print(f"[train] done. loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"({out['skipped']} skipped steps)")
    return out


if __name__ == "__main__":
    main()
