"""Dump, or compare, the LM scaffold's plain-tensor results bit for bit.

    PYTHONPATH=<tree>/src python scripts/torch_lm_bits.py --dump out.pt
    python scripts/torch_lm_bits.py --compare a.pt b.pt

For each of the ten SMOKE configs in float32 and bf16 (on the CPU, one
thread; an SSM with ``ssm_chunk=16``, an MoE at capacity factor 8): the
prefill logits of 2 x 32 tokens, one decode step's logits and the cache it
wrote, and the parameters after one train step of two microbatches.
``--compare`` exits 1 unless both dumps hold the same tensors, dtypes,
shapes and bits. Run it on two trees (``git archive`` of the parent under
a gitignored directory) to show that a change leaves the plain path's
results as they were.
"""

from __future__ import annotations

import argparse
import sys

import torch


def dump(path: str) -> int:
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_keys

    torch.set_num_threads(1)
    out = {}
    B, S = 2, 32
    for arch in ARCHS:
        for dt in ("float32", "bfloat16"):
            cfg = get_smoke_config(arch).replace(dtype=dt)
            if cfg.ssm_state:
                cfg = cfg.replace(ssm_chunk=16)
            if cfg.moe_num_experts:
                cfg = cfg.replace(moe_capacity_factor=8.0)
            params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            toks = torch.randint(0, cfg.vocab_size, (B, S),
                                 generator=torch.Generator().manual_seed(1))
            batch = {"tokens": toks}
            if cfg.family == "encdec":
                batch["enc_embeds"] = torch.randn(B, cfg.enc_seq, cfg.d_model,
                                                  generator=torch.Generator().manual_seed(2))
            if cfg.family == "vlm":
                batch["prefix_embeds"] = torch.randn(B, cfg.num_prefix_tokens, cfg.d_model,
                                                     generator=torch.Generator().manual_seed(3))
            k = f"{arch}/{dt}"
            out[f"{k}/prefill"], cache = tr.prefill(params, cfg, batch, max_seq=S + 4)
            pos = torch.full((B,), S, dtype=torch.int32)
            out[f"{k}/decode"], cache = tr.decode_step(params, cfg, toks[:, :1], pos, cache)
            out.update({f"{k}/cache/{p}": t for p, t in tree_keys(cache).items()})
            st = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
            st, m = steps.make_train_step(cfg, microbatches=2)(
                st, dict(batch, targets=torch.roll(toks, 1, 1)))
            out[f"{k}/loss"] = torch.tensor(m["loss"])
            out.update({f"{k}/param/{p}": t for p, t in tree_keys(st.params).items()})
    torch.save(out, path)
    print(f"{len(out)} tensors -> {path}")
    return 0


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    if a.keys() != b.keys():
        print(f"different keys: {sorted(set(a) ^ set(b))[:10]}")
        return 1
    bad = [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
           or not torch.equal(a[k].reshape(-1).view(torch.uint8),
                              b[k].reshape(-1).view(torch.uint8))]
    print(f"{len(a)} tensors, {len(bad)} differ" + (f": {bad[:10]}" if bad else ""))
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--dump", metavar="OUT")
    g.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    return dump(args.dump) if args.dump else compare(*args.compare)


if __name__ == "__main__":
    sys.exit(main())
