#!/usr/bin/env python3
"""Runs the PyTorch port on one CUDA card and checks it end to end.

    PYTHONPATH=src python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. every CUDA source of the port built with nvcc (all at once), then
     each kernel held against its plain version on the card at the main
     path's shapes and timed beside its plain version, one PyTorch
     library call and its bound;
  3. a reduced qwen3-0.6b in fp32, attention through the kernel against
     the plain path;
  4. the main path: full-width, full-depth qwen3-0.6b in bf16 on random
     weights serving 8 requests through ServeEngine, with the launch
     counts set to 0 just before and read just after; then the fused
     RMSNorm's own entry point, counted the same way;
  5. host wall time against device-busy time (torch.profiler) for one
     decode step and one prefill of the main path;
  6. one JSON line of per-kernel numbers and, last, the device line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
from repro_torch.models.model import Model
from repro_torch.serving import RequestQueue, ServeEngine

#: H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside them,
#: and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
       torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(got, want, atol, rtol, what):
    """Max |got - want|, failing unless every element is within
    atol + rtol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{what}: max abs err {float(err.max())} beyond atol {atol} "
          f"rtol {rtol}")
    return float(err.max())


def time_ms(fn, reps: int = 50) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls, queued behind a device-side sleep so that the host's launch
    cost does not open gaps between them. Inputs stay warm in L2, as
    they are on the main path, where the producer has just written them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)        # ~50 ms of device-side spinning
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_flash(gen, b, s, h, hkv, d, dtype):
    q = randn(gen, (b, s, h, d), dtype)
    k = randn(gen, (b, s, hkv, d), dtype)
    v = randn(gen, (b, s, hkv, d), dtype)
    out = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    err = max_err(out, attention_ref(q, k, v), **TOL[dtype],
                  what=f"flash attention b={b} s={s} h={h}/{hkv} d={d}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    size = q.element_size()
    ms_bound, bound_by = bound(4 * d * b * h * s * (s + 1) / 2,
                               size * b * s * d * (2 * h + 2 * hkv), dtype)
    return dict(
        shape=f"b={b} s={s} h={h} hkv={hkv} d={d} {str(dtype)[6:]}",
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention_cuda(q, k, v)),
        plain_ms=time_ms(lambda: attention_ref(q, k, v)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=ms_bound, bound_by=bound_by)


def check_rmsnorm(gen, shape, dtype):
    x = randn(gen, shape, dtype)
    r = randn(gen, shape, dtype)
    w = randn(gen, shape[-1:], dtype)
    x2, r2 = x.reshape(-1, shape[-1]), r.reshape(-1, shape[-1])
    y, s = fused_rmsnorm_cuda(x2, r2, w)
    torch.cuda.synchronize()
    yr, sr = fused_rmsnorm_ref(x2, r2, w)
    err = max(max_err(y, yr, **TOL[dtype], what=f"rmsnorm y {shape}"),
              max_err(s, sr, **TOL[dtype], what=f"rmsnorm x+r {shape}"))
    n = x.numel()
    ms_bound, bound_by = bound(5 * n, x.element_size() * (4 * n + shape[-1]),
                               dtype)
    d = shape[-1]
    return dict(
        shape=f"{tuple(shape)} {str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(lambda: fused_rmsnorm_cuda(x2, r2, w)),
        plain_ms=time_ms(lambda: fused_rmsnorm_ref(x2, r2, w)),
        library_ms=time_ms(lambda: F.rms_norm(x2 + r2, (d,), w, 1e-6)),
        bound_ms=ms_bound, bound_by=bound_by)


def print_rows(name, rows):
    for row in rows:
        print(f"  {name} {row['shape']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), max "
              f"abs err {row['max_abs_err']:.3g}")


# --------------------------------------------------------------------------
# phases 3 and 4: the model
# --------------------------------------------------------------------------

def model_parity():
    """Reduced qwen3-0.6b in fp32: the kernel path against the plain one."""
    plain = Model(reduced_config("qwen3-0.6b"))
    kernel = Model(reduced_config("qwen3-0.6b", attn_impl="kernel"))
    params = plain.init(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, plain.cfg.vocab, (2, 200), generator=gen,
                           device="cuda")
    want, _ = plain.forward(params, {"tokens": tokens})
    got, _ = kernel.forward(params, {"tokens": tokens})
    return max_err(got, want, **MODEL_TOL, what="reduced qwen3 logits")


def serve_main_path():
    """Full qwen3-0.6b serving 8 requests; returns (model, params, engine,
    results, flash launches, prompt lengths, wall seconds)."""
    cfg = get_config("qwen3-0.6b", attn_impl="kernel")
    model = Model(cfg)
    params = model.init(seed=0)
    engine = ServeEngine(model, params, n_slots=4, max_len=1024)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(16, 513, size=8)]
    check(any(n % 64 for n in lengths), "a ragged prompt length")
    queue = RequestQueue()
    for n in lengths:
        queue.submit(rng.integers(0, cfg.vocab, size=n), max_new_tokens=32)
    torch.cuda.synchronize()
    flash_ops.launches = 0
    t0 = time.perf_counter()
    results = engine.run(queue)
    wall = time.perf_counter() - t0
    launches = flash_ops.launches
    check(len(results) == 8, f"8 requests finish, got {len(results)}")
    for r in results:
        check(len(r.tokens) == 32, f"request {r.uid}: 32 tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens),
              f"request {r.uid}: tokens in [0, vocab)")
    for name, t in engine.cache["layers"].items():
        check(bool(torch.isfinite(t).all()), f"finite KV cache {name}")
    check(launches == cfg.n_layers * engine.n_prefills,
          f"flash launches {launches} == {cfg.n_layers} x "
          f"{engine.n_prefills} prefills")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=300),
                             device="cuda")[None]
    logits, _ = model.prefill(params, {"tokens": prompt}, max_len=1024)
    check(logits.shape == (1, 1, cfg.padded_vocab), "prefill logits shape")
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "finite prefill logits")
    return model, params, engine, results, launches, lengths, wall


def where_time_goes(model, params, engine, n: int = 5):
    """Host wall time against device-busy time (the sum of the kernels'
    times in a torch.profiler trace) for one decode step of the 4-slot
    batch and one 512-token prefill, warm, as the main path runs them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prompt = torch.randint(0, model.cfg.vocab, (1, 512), device="cuda")
    calls = {
        "decode step, 4 slots": lambda: model.decode_step(
            params, engine.cache, engine.last_tokens),
        "prefill, 512 tokens": lambda: model.prefill(
            params, {"tokens": prompt}, max_len=engine.max_len)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # kernel rows only: a CPU op's row repeats its kernels' time
        rows = sorted((r for r in prof.key_averages()
                       if r.device_type == DeviceType.CUDA),
                      key=lambda r: -r.self_device_time_total)
        device_ms = sum(r.self_device_time_total for r in rows) / n / 1e3
        flash_ms = sum(r.self_device_time_total for r in rows
                       if "flash_fwd" in r.key) / n / 1e3
        if device_ms == 0.0:
            print(f"  {name}: wall {wall_ms:.3f} ms; device time not "
                  f"measured (the profiler saw no kernel)")
            continue
        print(f"  {name}: wall {wall_ms:.3f} ms, device busy "
              f"{device_ms:.3f} ms (idle share "
              f"{1 - device_ms / wall_ms:.3f}), flash attention "
              f"{flash_ms:.3f} ms; top kernels:")
        for r in rows[:6]:
            print(f"    {r.self_device_time_total / n / 1e3:.3f} ms "
                  f"x{r.count // n} {r.key[:90]}")


def rmsnorm_entry_point():
    """The fused RMSNorm's own path: its public entry point on the
    residual stream of a 4 x 512-token batch of qwen3-0.6b (d = 1024)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, r = (randn(gen, (4, 512, 1024), torch.bfloat16) for _ in range(2))
    w = randn(gen, (1024,), torch.bfloat16)
    rms_ops.launches = 0
    y, s = rms_ops.fused_rmsnorm(x, r, w)
    torch.cuda.synchronize()
    launches = rms_ops.launches
    check(launches == 1, f"fused RMSNorm launched once, got {launches}")
    check(y.shape == x.shape and bool(torch.isfinite(y).all()),
          "finite normed rows")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for stem, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rows = [check_flash(gen, b, s, 16, 8, 128, torch.bfloat16)
                  for b in (1, 4) for s in (37, 128, 512, 1000)]
    flash_rows += [check_flash(gen, 1, 512, 16, 1, 64, torch.bfloat16),
                   check_flash(gen, 1, 512, 16, 8, 128, torch.float32)]
    print_rows("flash_attention", flash_rows)
    rms_rows = [check_rmsnorm(gen, shape, dtype)
                for shape in ((2048, 1024), (2, 64, 128), (4, 100, 256),
                              (512, 384), (1, 7, 64))
                for dtype in (torch.bfloat16, torch.float32)]
    print_rows("fused_rmsnorm", rms_rows)

    err = model_parity()
    print(f"reduced qwen3-0.6b fp32, kernel vs plain logits: max abs err "
          f"{err:.3g}")

    model, params, engine, results, flash_launches, lengths, wall = \
        serve_main_path()
    n_tokens = sum(len(r.tokens) for r in results)
    busy = engine.prefill_s + engine.decode_s
    print(f"served {len(results)} requests, prompts {sorted(lengths)}, "
          f"{n_tokens} tokens in {wall:.3f} s: prefill "
          f"{engine.prefill_s / engine.n_prefills * 1e3:.3f} ms per request, "
          f"decode {engine.decode_s / engine.decode_steps * 1e3:.3f} ms per "
          f"step ({engine.decode_steps} steps, 4 slots), "
          f"{n_tokens / busy:.1f} tokens/s; flash launches {flash_launches}")
    rms_launches = rmsnorm_entry_point()
    print("where the time goes (qwen3-0.6b bf16, warm):")
    where_time_goes(model, params, engine)

    main_flash = flash_rows[2]             # b=1 s=512: a full-length prompt
    main_rms = rms_rows[0]                 # 4 x 512 tokens x d=1024, bf16
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:101",
             launches=flash_launches),
        dict(name="fused_rmsnorm", route="triton",
             source="src/repro_torch/kernels/rmsnorm/kernel.py",
             replaces="src/repro/kernels/rmsnorm/kernel.py:40",
             launches=rms_launches),
    ]
    for entry, row in zip(kernels, (main_flash, main_rms)):
        entry.update({k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}, shape=row["shape"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
