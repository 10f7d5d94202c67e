"""End-to-end LM training driver, as the reference's ``examples/train_lm.py``.

The default run trains a ~15M-parameter mamba2-family model (full depth,
d_model 256, vocab 8,192) for 200 steps on the synthetic token pipeline,
through the whole production path (train step, AdamW + cosine,
checkpoint/resume, NaN guard, heartbeat); the reference patches
``get_config`` to run that variant, the port hands it to ``train``.
``--full`` trains the published config:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --full --steps 300 \\
        --batch 16 --seq 1024

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from ..configs import get_config
from ..launch.train import train


def small_config(arch: str):
    """The same-family ~15M-parameter variant: full depth, reduced width."""
    base = get_config(arch)
    return base.replace(d_model=256, num_heads=8, num_kv_heads=8, vocab_size=8192,
                        **({"d_ff": 1024} if base.d_ff else {}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--full", action="store_true",
                    help="train the full assigned config (accelerator-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="artifacts/example_lm_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = train(args.arch, smoke=False, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, device=args.device,
                cfg=None if args.full else small_config(args.arch))
    print(f"[example] initial loss {out['losses'][0]:.4f} -> "
          f"final {out['losses'][-1]:.4f} over {len(out['losses'])} steps")
    assert out["losses"][-1] < out["losses"][0], "training must reduce loss"
    return out


if __name__ == "__main__":
    main()
