"""Per-model step-time profiler.

Times, on the GPU with the chained-iteration ``time_op``:

  * the full jitted MTL train step at the reference batch (48) and each
    model's reference input geometry,
  * the forward pass alone,
  * isolated sub-blocks (conv trunk / LRN / dense stack) for the CNNs,

and reports XLA's cost analysis (FLOPs and bytes accessed) so achieved
FLOP/s and achieved memory bandwidth against the card's published peaks
(``PEAKS``, keyed by ``device_kind``) tell whether a step time is a
lowering problem or an honest roofline.  Writes one JSON with
everything.

Every model is measured in its OWN subprocess, one at a time (shared
persistent compile cache), so each program is timed alone; the parent
never touches the device, so one JAX process holds the card.

    python tools/profile_models.py --out bench_out/profile_models.json
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model
from sm_hpss_mtl_tpu.train import TrainState, for_model
from sm_hpss_mtl_tpu.train.state import make_train_step
from sm_hpss_mtl_tpu.utils.benchmarking import time_op
from sm_hpss_mtl_tpu.utils.compile_cache import enable_compile_cache
from sm_hpss_mtl_tpu.utils.device import device_report, require_gpu

# Reference geometries: (model, input shape at batch 48, W=68).
CASES = {
    "Doukhan_et_al_MTL": (48, 240, 68, 1),       # MelHarmPercSpec 120x2
    "Papakostas_et_al_MTL": (48, 402, 68, 1),    # HarmPercSpec 201x2
    "Jang_et_al_MTL": (48, 514, 68, 1),          # LogHarmPercSpec 257x2
    "Lemaire_et_al_MTL": (48, 68, 240),          # time_mel
}


def mtl_labels(n):
    y = np.arange(n) % 3
    onehot = np.zeros((n, 3), np.float32)
    onehot[np.arange(n), y] = 1
    return {
        "S": jnp.asarray((y == 1).astype(np.float32)),
        "M": jnp.asarray((y == 0).astype(np.float32)),
        "R": jnp.asarray(np.stack([(y == 0), (y == 1)], -1)
                         .astype(np.float32)),
        "3C": jnp.asarray(onehot),
    }


#: Published peaks per card, keyed by ``jax.Device.device_kind``.
#: Source: NVIDIA H100 SXM data sheet (dense, no sparsity), at the full
#: 700 W power limit; a card set below it cannot hold its top clock.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                              "tf32_tflops": 495.0, "fp32_tflops": 67.0},
}


def peaks_for(device_kind: str) -> dict:
    """The peak table entry for a card; an unknown card is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"add its data-sheet row to PEAKS")
    return PEAKS[device_kind]


def cost_of(fn, *args):
    """(flops, bytes_accessed) from XLA's own cost model — bytes
    accessed is the compiler's HBM-traffic estimate across fusion
    boundaries, the numerator of the bandwidth roofline."""
    try:
        comp = jax.jit(fn).lower(*args).compile()
        cost = comp.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        return (float(cost.get("flops", float("nan"))),
                float(cost.get("bytes accessed", float("nan"))))
    except Exception:
        return float("nan"), float("nan")


def flops_of(fn, *args):
    return cost_of(fn, *args)[0]


def time_train_step(name, spec, x, labels, rng):
    opt, _ = for_model(name, tr_steps=1000)
    state = TrainState.create(spec.module, opt, x, rng)
    step = make_train_step(spec.module, opt, mtl=True)

    def carry_step(carry):
        st, xx = carry
        st2, _ = step(st, xx, labels, rng)
        return (st2, xx)

    t = time_op(carry_step, (state, x), iters=(2, 10), repeats=3)
    if t * 1e3 < 0.05:
        # Sub-50us differencing underflows in a noisy window (seen as a
        # 0.0 row for the Lemaire TCN); re-measure with a longer chain.
        t = time_op(carry_step, (state, x), iters=(10, 110), repeats=3)
    fl, by = cost_of(lambda s, xx: step(s, xx, labels, rng)[0].params,
                     state, x)
    return t, fl, by


def time_forward(spec, x, rng):
    variables = spec.module.init({"params": rng, "dropout": rng}, x,
                                 train=False)

    # Weights ride the carry, NOT a closure: closed-over params would be
    # baked into the HLO as constants.
    def fwd(vv, xx):
        out = spec.module.apply(vv, xx, train=False)
        return out["3C"] if isinstance(out, dict) else out

    def carry_step(carry):
        vv, xx = carry
        p = fwd(vv, xx)
        return (vv, xx * (1.0 + 1e-12 * jnp.sum(p)))

    t = time_op(carry_step, (variables, x), iters=(2, 10), repeats=3)
    if t * 1e3 < 0.05:
        t = time_op(carry_step, (variables, x), iters=(10, 110), repeats=3)
    return t, flops_of(fwd, variables, x)


def time_block(fn, x):
    def carry_step(xx):
        y = fn(xx)
        s = jnp.sum(y.astype(jnp.float32))
        return xx * (1.0 + 1e-12 * s)
    t = time_op(carry_step, x, iters=(2, 10), repeats=3)
    if t * 1e3 < 0.05:
        t = time_op(carry_step, x, iters=(10, 110), repeats=3)
    return t, flops_of(fn, x)


def lrn_block(x):
    from sm_hpss_mtl_tpu.models.cnn import local_response_normalization
    return local_response_normalization(x)


def model_row(name, peaks: dict | None = None):
    """One model's row; ``peaks`` defaults to this device's entry."""
    peaks = peaks or peaks_for(jax.devices()[0].device_kind)
    rng = jax.random.PRNGKey(0)
    labels = mtl_labels(48)
    shape = CASES[name]
    x = jax.random.normal(rng, shape, jnp.float32)
    # Zoo defaults = reference geometry (Jang MTL keeps its internal
    # 120-band mel-scale layer regardless of the raw-spec features).
    spec = get_model(name)
    t_step, fl_step, by_step = time_train_step(name, spec, x, labels, rng)
    t_fwd, fl_fwd = time_forward(spec, x, rng)
    spec16 = get_model(name, dtype=jnp.bfloat16)
    t16, fl16, by16 = time_train_step(name, spec16, x, labels, rng)
    gbps = by_step / t_step / 1e9
    return {
        "input": list(shape),
        "train_step_ms": round(t_step * 1e3, 3),
        "train_step_gflops": round(fl_step / 1e9, 2),
        "train_step_tflops_per_s": round(fl_step / t_step / 1e12, 2),
        "train_step_bytes_gb": round(by_step / 1e9, 3),
        "train_step_achieved_gbps": round(gbps, 1),
        "train_step_hbm_frac": round(gbps / peaks["hbm_gbps"], 3),
        "train_step_bf16_ms": round(t16 * 1e3, 3),
        "train_step_bf16_achieved_gbps": round(by16 / t16 / 1e9, 1),
        "forward_ms": round(t_fwd * 1e3, 3),
        "forward_gflops": round(fl_fwd / 1e9, 2),
        "forward_tflops_per_s": round(fl_fwd / t_fwd / 1e12, 2),
    }


def lrn_rows():
    rng = jax.random.PRNGKey(0)
    rows = {}
    for tag, shape in (("lrn_c1", (48, 199, 32, 96)),
                       ("lrn_c2", (48, 49, 7, 384))):
        x = jax.random.normal(rng, shape, jnp.float32)
        t, fl = time_block(lrn_block, x)
        rows[tag] = {"shape": list(shape), "ms": round(t * 1e3, 3)}
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(REPO, "bench_out",
                                                 "profile_models.json"))
    p.add_argument("--child", default=None,
                   help="internal: profile one model (or 'lrn') and print "
                        "its JSON row")
    args = p.parse_args(argv)

    enable_compile_cache()
    if args.child:
        require_gpu()
        row = lrn_rows() if args.child == "lrn" else model_row(args.child)
        print(json.dumps({"child": args.child, "row": row,
                          "device": device_report()}))
        return

    report = {"models": {},
              "methodology": "each model profiled in its own subprocess, "
                             "one at a time; time_op chained-iteration "
                             "differencing"}
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for child in list(CASES) + ["lrn"]:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", child]
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"child {child} failed\n{proc.stdout[-2000:]}"
                               f"\n{proc.stderr[-2000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        row = out["row"]
        report["device"] = out["device"]
        if child == "lrn":
            report.update(row)
        else:
            report["models"][child] = row
        print(child, json.dumps(row), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("->", args.out)


if __name__ == "__main__":
    main()
