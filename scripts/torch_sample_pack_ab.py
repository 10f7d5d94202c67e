"""Time the port's sample-surplus kernel wrapper with two ways of moving its
scalars to the card, in one process on one GPU, in turns (old, new, new,
old).

* old: six values, each copied to the card by a blocking ``.to("cuda")``;
  every such copy synchronises the stream, so the card idles while the
  wrapper's Python runs;
* new: ``kernels/screen.py::pack_sample_scalars``, one host vector and one
  non-blocking copy.

X is fp32 50,000 x 10,000 (2.0 GB), random from a seeded CUDA generator.
Prints one JSON line of mean ms per call (CUDA events over 50 calls), and
``torch.mv(X.t(), w1)`` beside them. Needs a CUDA GPU and nvcc:

    python scripts/torch_sample_pack_ab.py
"""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import screen  # noqa: E402


def timed_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def old_pack(b1, dw, db, shrink_factor, margin_floor, has_history, device="cpu"):
    vals = [b1, dw, db, shrink_factor, margin_floor, float(bool(has_history))]
    v = torch.stack([torch.as_tensor(x, dtype=torch.float32).to(device).reshape(())
                     for x in vals])
    v[1:3] = torch.clamp_max(v[1:3], 1e30)
    return torch.nn.functional.pad(v, (0, screen.NUM_SCALARS - v.shape[0]))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    m, n = 50_000, 10_000
    X = torch.randn(m, n, device="cuda", generator=g)
    w1 = torch.randn(m, device="cuda", generator=g) * 0.01
    y = torch.where(torch.rand(n, device="cuda", generator=g) < 0.5, 1.0, -1.0)
    u_prev = torch.randn(n, device="cuda", generator=g)
    args = (X, w1, y, 0.1, 0.3, 0.02, u_prev)
    new_pack = screen.pack_sample_scalars
    out = {}
    for label in ("old", "new", "new2", "old2"):
        screen.pack_sample_scalars = old_pack if label.startswith("old") else new_pack
        out[label] = timed_ms(lambda: screen.sample_surplus_op(*args))
    screen.pack_sample_scalars = new_pack
    out["mv_ms"] = timed_ms(lambda: torch.mv(X.t(), w1))
    print(json.dumps({"ab_pack_ms": out, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
