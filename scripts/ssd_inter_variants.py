#!/usr/bin/env python3
"""Times variants of the SSD inter kernel's design on a card.

    PYTHONPATH=src python3 scripts/ssd_inter_variants.py

Builds copies of ``kernels/ssd_scan/csrc/ssd_scan.cu`` with another ring
depth (``Inter::STAGES``) or head_dim tile width (``Inter::PT``) into
``build/ssd_inter_variants/``, checks each against the plain version
(the last state bit for bit, y within the tolerance) at zamba2-1.2b's
prefill shape (b=1, s=512, h=64, n=p=64, q=128), and times them in
turns with CUDA events, four times each. Then it times the shipped
kernel over 1, 2, 4 and 8 chunks at the same width, which shows what one
more chunk step of a block costs. Prints the card and one line per
variant; the shipped design is (stages 2, tile 32).
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import TOL, randn, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_inter_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_inter_scan_ref  # noqa: E402
from repro_torch.models.mamba2 import chunk_recurrence  # noqa: E402

SRC = _build.KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan.cu"
HEADER = _build.KERNELS_DIR / "csrc" / "mma_sm90.cuh"
OUT = ROOT / "build" / "ssd_inter_variants"
#: (ring stages, head_dim tile) per route; the first is the shipped one
VARIANTS = {torch.bfloat16: [(2, 32), (3, 32), (4, 32), (2, 16), (2, 64)],
            torch.float32: [(2, 32), (3, 32), (2, 64)]}


def build(variants):
    """{(stages, tile): the variant's ssd_inter_fwd}, all nvcc at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text().replace('"../../csrc/mma_sm90.cuh"',
                                   f'"{HEADER}"')
    jobs = {}
    for stages, tile in variants:
        src = OUT / f"inter_s{stages}_t{tile}.cu"
        src.write_text(
            text.replace("static constexpr int STAGES = 2;",
                         f"static constexpr int STAGES = {stages};")
                .replace("P < 32 ? P : 32", f"P < {tile} ? P : {tile}"))
        lib = src.with_suffix(".so")
        jobs[stages, tile] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode or re.search(r"[1-9]\d* bytes spill", log):
            raise RuntimeError(f"variant {key} failed to build cleanly:\n"
                               f"{log}")
        fn = ctypes.CDLL(str(lib)).ssd_inter_fwd
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def inputs(gen, s, dtype, b=1, h=64, p=64, n=64, q=128):
    """The intra pass's outputs on random inputs, as the inter pass gets
    them on the main path."""
    c = s // q
    xh = randn(gen, (b, c, q, h, p), dtype)
    bm, cm = (randn(gen, (b, c, q, n), dtype) for _ in range(2))
    dt = torch.nn.functional.softplus(randn(gen, (b, c, q, h), torch.float32))
    log_a = -dt * torch.exp(randn(gen, (b, c, q, h), torch.float32) * 0.3)
    y_intra, s_chunk, dec, cum = ops.ssd_intra(xh, bm, cm, log_a, dt)
    return cm, cum, s_chunk, dec, y_intra


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_inter_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build(sorted({v for vs in VARIANTS.values() for v in vs}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, variants in VARIANTS.items():
        cm, cum, s_chunk, dec, y_intra = args = inputs(gen, 512, dtype)
        b, c, q, n = cm.shape
        h, p = cum.shape[-1], y_intra.shape[-1]
        want_y, want_h = ssd_inter_scan_ref(*args, dtype)
        y = torch.empty_like(y_intra, dtype=dtype)
        h_last = torch.empty_like(want_h)
        code = 1 if dtype == torch.bfloat16 else 0

        def run(key):
            err = fns[key](code, n, p, *(t.data_ptr() for t in args), None,
                           y.data_ptr(), h_last.data_ptr(), b, c, q, h,
                           stream)
            if err:
                raise RuntimeError(f"variant {key}: CUDA error {err}")

        for key in variants:
            run(key)
            torch.cuda.synchronize()
            if not torch.equal(h_last, want_h):
                raise RuntimeError(f"variant {key}: last state differs")
            torch.testing.assert_close(y.float(), want_y.float(),
                                       **TOL[dtype])
        times = {key: [] for key in variants}
        for key in variants + variants[::-1] + variants + variants[::-1]:
            times[key].append(time_ms(lambda: run(key), reps=100))
        for (stages, tile), ts in times.items():
            print(f"{str(dtype)[6:]} stages {stages} tile {tile}: "
                  f"{' '.join(f'{t:.5f}' for t in ts)} ms")
    for s in (128, 256, 512, 1024):
        args = inputs(gen, s, torch.bfloat16)
        ms = time_ms(lambda: ssd_inter_cuda(*args, torch.bfloat16), reps=100)
        print(f"bfloat16 shipped kernel, {s // 128} chunks (s={s}, h=64): "
              f"{ms:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
