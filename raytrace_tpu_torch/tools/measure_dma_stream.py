"""P1 on the card: the cost of bringing a data-dependent table row in.

The port's copy of ``tools/measure_dma_stream.py``, the TPU probe that
sized a stream-kernel leaf visit (a serial chain of dynamic-row copies from
device memory into fast memory). Its kernel, ``csrc/dma_probe.cu``, runs
the same chain in three variants (``VARIANTS``: a direct read through the
read-only cache, a warp's ``cp.async`` copy into shared memory, a bulk
copy completing on an ``mbarrier``); ``chain_plain`` is its plain PyTorch
version, which each variant equals bit for bit.

    python -m raytrace_tpu_torch.tools.measure_dma_stream [n_steps]

prints, for each shape of ``SHAPES`` and each variant: ok, got, want, ms
and ns per step (best of ``REPS`` launches, CUDA events), then the card's
name and power limit. It needs a CUDA GPU.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 8192          # the TPU tool's table: 8192 rows
ROW_F32 = 128          # of 128 floats
N_STEPS = 2000         # its default chain length
VARIANTS = ("ld", "cp_async", "tma")
# (name, rows, floats a row, L2 state): the TPU tool's own table; rows of
# a 32-row leaf of 23-float stream rows (2,944 B) over a table the size of
# the stream table at the 262,144-primitive cap (24 MB, inside the 50 MB
# L2), warm; the same rows over 96.5 MB, twice the L2, flushed before each
# launch. Row counts are powers of two: the index map then has a full
# period (2^32 wraps onto it), so a chain of 2,000 steps visits 2,000
# rows; with 45,590 rows (128 MiB) it falls into short cycles that the
# L1 serves.
SHAPES = (("tool", N_ROWS, ROW_F32, "warm"),
          ("leaf-L2", 8192, 32 * 23, "warm"),
          ("leaf-HBM", 32768, 32 * 23, "flushed"))
REPS = 5
FLUSH_BYTES = 256 << 20   # written between launches: past the 50 MB L2
HBM_BYTES_PER_S = 3.35e12

# Kernel launches since the last reset_launches(), by variant.
LAUNCHES = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def make_table(n_rows: int = N_ROWS, row_floats: int = ROW_F32):
    """The TPU tool's table, (arange % 1000) * 1e-3 in float32, as a CPU
    tensor."""
    tab = (np.arange(n_rows * row_floats, dtype=np.float32)
           .reshape(n_rows, row_floats) % 1000) * 1e-3
    return torch.from_numpy(np.ascontiguousarray(tab, dtype=np.float32))


def chain_plain(table: torch.Tensor, n_steps: int = N_STEPS,
                seed: int = 0) -> torch.Tensor:
    """The chain in float32 and int32 tensor ops on the table's device:
    acc = (acc + row[0]) + row[-1]; idx = (idx * 1664525 + 1013904223 +
    int32(row[0])) % n_rows, the product wrapping in int32 and % a floor
    modulo. Returns acc, (1,) float32."""
    n_rows = table.shape[0]
    idx = torch.tensor(seed, dtype=torch.int32, device=table.device)
    acc = torch.zeros((), dtype=torch.float32, device=table.device)
    for _ in range(n_steps):
        row = table[idx]
        v0, v1 = row[0], row[-1]
        acc = (acc + v0) + v1
        idx = (idx * 1664525 + 1013904223 + v0.to(torch.int32)) % n_rows
    return acc.reshape(1)


def _check(table, n_steps, seed, variant):
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError("table: a (rows, floats) float32 tensor")
    if not 0 <= seed < table.shape[0]:
        raise ValueError(f"seed {seed}: the first row, in [0, "
                         f"{table.shape[0]})")
    if n_steps < 0:
        raise ValueError(f"n_steps {n_steps} < 0")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")


def prepare_chain(table: torch.Tensor, n_steps: int = N_STEPS,
                  seed: int = 0, variant: str = "ld"):
    """P1's kernel on a CUDA table: returns (out, launch); ``launch()``
    runs the chain into ``out``, (1,) float32, and counts it under the
    variant in ``LAUNCHES``."""
    from ..ops import _build
    _check(table, n_steps, seed, variant)
    if table.device.type != "cuda":
        raise RuntimeError(f"P1: device {table.device} is not CUDA")
    row_floats = table.shape[1]
    if variant != "ld" and (row_floats % 4 or row_floats * 4 > 48 * 1024):
        raise ValueError(f"{variant}: rows of a multiple of 4 floats, at "
                         f"most 48 KB, not {row_floats}")
    tab = table.contiguous()
    if tab.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned")
    out = torch.empty(1, dtype=torch.float32, device=tab.device)
    lib = _build.library()
    code = VARIANTS.index(variant)

    def launch():
        err = lib.rt_dma_probe(
            tab.data_ptr(), tab.shape[0], row_floats, n_steps, seed, code,
            out.data_ptr(), torch.cuda.current_stream(tab.device).cuda_stream)
        _build.check(err, f"dma_probe {variant}")
        LAUNCHES[variant] += 1

    return out, launch


def chain(table: torch.Tensor, n_steps: int = N_STEPS, seed: int = 0,
          variant: str = "ld") -> torch.Tensor:
    """The chain's acc, (1,) float32: P1's kernel (``variant``) for a CUDA
    table, ``chain_plain`` for a CPU one."""
    if table.device.type == "cpu":
        _check(table, n_steps, seed, variant)
        return chain_plain(table, n_steps, seed)
    out, launch = prepare_chain(table, n_steps, seed, variant)
    launch()
    return out


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi: no output"


def measure(n_steps: int = N_STEPS, shapes=SHAPES, seed: int = 0):
    """Every variant at every shape on the card: a list of dicts (shape,
    variant, rows, row_bytes, ok, got, want, ms, ns_per_step, bound_ms,
    plain_ms). ``ms`` is the best of REPS launches; a "flushed" shape
    writes FLUSH_BYTES before each launch, so its rows come from HBM."""
    dev = torch.device("cuda")
    flush = None
    out = []
    for name, n_rows, row_floats, l2 in shapes:
        table = make_table(n_rows, row_floats).to(dev)
        if l2 == "flushed" and flush is None:
            flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = chain_plain(table, n_steps, seed)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for variant in VARIANTS:
            got, launch = prepare_chain(table, n_steps, seed, variant)
            launch()  # warm-up: builds, and warms the L2 for "warm"
            best = float("inf")
            for _ in range(REPS):
                if flush is not None and l2 == "flushed":
                    flush.fill_(1)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            row_bytes = 4 * row_floats
            out.append(dict(
                shape=name, variant=variant, rows=n_rows,
                row_bytes=row_bytes, l2=l2, n_steps=n_steps,
                ok=bool(torch.equal(got, want)), got=float(got[0]),
                want=float(want[0]), ms=best,
                ns_per_step=best * 1e6 / max(n_steps, 1),
                bound_ms=n_steps * row_bytes / HBM_BYTES_PER_S * 1e3,
                plain_ms=plain_ms))
        del table
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_steps = int(argv[0]) if argv else N_STEPS
    if not torch.cuda.is_available():
        print("measure_dma_stream: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    rows = measure(n_steps)
    for r in rows:
        print(f"{r['shape']} ({r['rows']} x {r['row_bytes']} B, L2 "
              f"{r['l2']}) {r['variant']}: ok={r['ok']} got={r['got']:.3f} "
              f"want={r['want']:.3f} {r['ms']:.4f} ms, "
              f"{r['ns_per_step']:.1f} ns/step; plain {r['plain_ms']:.1f} ms")
    print(name)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
