"""Float64 witness for the olmo-1b prefill/decode parity test.

Runs the test's case (``tests/test_torch_llm.py::
test_prefill_then_decode_matches_reference[olmo-1b]``: reduced olmo-1b in
float32, B=2, a 12-token prompt, 3 decode steps) through the JAX package,
the port, and the port's own code in float64 (``Tensor.float`` made to
give float64, so the float32 casts inside the layers keep float64), and
says for each forward which side is further from float64:

  * the worst logit of |port - reference| over the test's tolerance;
  * at that logit, each side's error against float64, split into what
    the lm head inherits from its input (the final-norm output, carried
    through an exact dot) and what the head's own float32 sum adds;
  * each side's worst error against float64 over all logits and after
    each block.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/olmo_decode_witness.py \\
        --hash-seeds 0-35 --draw hash

``--draw hash`` draws the weights with the JAX package's ``init_params``,
whose per-leaf seed is ``hash(path)`` and so moves with
``PYTHONHASHSEED`` (one process per seed); ``--draw test`` draws them as
the test does (a ``zlib.crc32`` seed, the same in every process).  Prints
one JSON line per seed and a summary line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _test_module():
    spec = importlib.util.spec_from_file_location(
        "test_torch_llm", ROOT / "tests" / "test_torch_llm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _map(tree, f):
    if isinstance(tree, dict):
        return {k: _map(v, f) for k, v in tree.items()}
    return f(tree)


def one(draw: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.models import registry as JR
    from repro.models import transformer as jtr
    from repro.models.param import init_params
    from repro_torch import interop
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as ttr

    t = _test_module()
    jc, tc = t._cfgs("olmo-1b", "float32")
    if draw == "test":
        pj, pt = t._params(jc, "float32")
    else:
        pj = jax.tree.map(lambda a: a.astype(jnp.float32),
                          init_params(JR.specs(jc), t.KEY))
        pt = interop.params_from_jax(jax.tree.map(np.asarray, pj),
                                     torch.device("cpu"))
    toks = t._batch(jc.vocab, 2, 12)["tokens"]
    rng = np.random.default_rng(6)
    steps = [rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
             for _ in range(3)]

    def ref():
        blocks, heads = [], []
        ob, oh = jtr._dense_block, jtr.lm_logits

        def blk(*a, **k):
            out = ob(*a, **k)
            jax.debug.callback(lambda v: blocks.append(np.asarray(v)),
                               out[0], ordered=True)
            return out

        def head(p, x, cfg):
            jax.debug.callback(lambda v: heads.append(np.asarray(v)), x,
                               ordered=True)
            return oh(p, x, cfg)
        jtr._dense_block, jtr.lm_logits = blk, head
        try:
            lg, cache = JR.prefill(pj, {"tokens": jnp.asarray(toks)}, jc,
                                   20)
            outs = [np.asarray(lg)]
            for s in steps:
                lg, cache = JR.decode_step(pj, {"tokens": jnp.asarray(s)},
                                           cache, jc)
                outs.append(np.asarray(lg))
        finally:
            jtr._dense_block, jtr.lm_logits = ob, oh
        return [np.asarray(o, np.float64) for o in outs], blocks, heads

    def port(f64: bool):
        blocks, heads = [], []
        ob, oh, of = ttr._dense_block, ttr.lm_logits, torch.Tensor.float

        def blk(*a, **k):
            out = ob(*a, **k)
            blocks.append(out[0].detach().double().numpy())
            return out

        def head(p, x, cfg):
            heads.append(x.detach().double().numpy())
            return oh(p, x, cfg)
        cfg, params = tc, pt
        if f64:
            cfg = tc.replace(dtype=torch.float64)
            params = _map(pt, lambda a: a.double()
                          if a.is_floating_point() else a)
            torch.Tensor.float = lambda self, *a, **k: self.double()
        ttr._dense_block, ttr.lm_logits = blk, head
        try:
            lg, cache = R.prefill(params, {"tokens": toks}, cfg, 20,
                                  device="cpu")
            outs = [lg.detach().double().numpy()]
            for s in steps:
                lg, cache = R.decode_step(params, {"tokens": s}, cache, cfg,
                                          device="cpu")
                outs.append(lg.detach().double().numpy())
        finally:
            ttr._dense_block, ttr.lm_logits = ob, oh
            torch.Tensor.float = of
        return outs, blocks, heads

    r, rb, rh = ref()
    p, pb, ph = port(False)
    w, wb, wh = port(True)
    tok = np.asarray(pj["embed"]["tok"], np.float64)
    res = {"hashseed": os.environ.get("PYTHONHASHSEED"), "draw": draw,
           "forwards": []}
    for i, name in enumerate(["prefill", "decode1", "decode2", "decode3"]):
        ratio = np.abs(p[i] - r[i]) / (TOL + TOL * np.abs(r[i]))
        b, s, v = np.unravel_index(np.argmax(ratio), ratio.shape)
        pos = -1 if i == 0 else 0          # prefill keeps the last token
        xr = rh[i][b, pos].astype(np.float64)
        xp, xw = ph[i][b, pos], wh[i][b, pos]
        row = tok[v]
        res["forwards"].append({
            "forward": name, "worst_ratio": float(ratio[b, s, v]),
            "logit": [int(b), int(v)], "w64": float(w[i][b, s, v]),
            "head_sum_abs_terms": float(np.abs(xw * row).sum()),
            "ref_err": float(r[i][b, s, v] - w[i][b, s, v]),
            "port_err": float(p[i][b, s, v] - w[i][b, s, v]),
            "ref_inherited": float(xr @ row - xw @ row),
            "ref_head_sum": float(r[i][b, s, v] - xr @ row),
            "port_inherited": float(xp @ row - xw @ row),
            "port_head_sum": float(p[i][b, s, v] - xp @ row),
            "ref_max_err": float(np.abs(r[i] - w[i]).max()),
            "port_max_err": float(np.abs(p[i] - w[i]).max()),
            "block_ref_max_err": [float(np.abs(np.asarray(rb[k], np.float64)
                                               - wb[k]).max())
                                  for k in (2 * i, 2 * i + 1)],
            "block_port_max_err": [float(np.abs(pb[k] - wb[k]).max())
                                   for k in (2 * i, 2 * i + 1)],
        })
    return res


def _seeds(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hash-seeds", default="24",
                    help="PYTHONHASHSEED values, N or LO-HI (default 24)")
    ap.add_argument("--draw", choices=["hash", "test"], default="hash")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.draw)))
        return
    rows = []
    for seed in _seeds(args.hash_seeds):
        env = dict(os.environ, PYTHONHASHSEED=str(seed))
        out = subprocess.run(
            [sys.executable, __file__, "--one", "--draw", args.draw],
            env=env, capture_output=True, text=True, check=True).stdout
        row = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(row))
        rows.append(row)
    fw = [f for row in rows for f in row["forwards"]]
    print(json.dumps({
        "summary": {
            "n_seeds": len(rows), "draw": args.draw,
            "worst_ratio": max(f["worst_ratio"] for f in fw),
            "ref_max_err": max(f["ref_max_err"] for f in fw),
            "port_max_err": max(f["port_max_err"] for f in fw),
            "forwards_port_further_than_ref": sum(
                f["port_max_err"] > f["ref_max_err"] for f in fw),
            "n_forwards": len(fw),
            "block_ref_max_err": max(max(f["block_ref_max_err"])
                                     for f in fw),
            "block_port_max_err": max(max(f["block_port_max_err"])
                                      for f in fw)}}))


if __name__ == "__main__":
    main()
