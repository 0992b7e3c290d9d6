#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Drives ``repro_torch`` (never the JAX package) through six phases and prints
one JSON object per line:

1. card      — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build     — builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
               (``nvcc``, one process per source) with ptxas register and
               shared-memory lines, and each kernel's static SASS opcode
               counts (``cuobjdump -sass``);
3. parity    — each kernel against its plain torch version on the card, bit
               for bit, over n in {2, 3, 6, 17, 137}, bits in {8, 13, 15},
               batch in {1, 7, 300, 65537}, int32 and int64 inputs, and
               worst-case (m-1)**2 products;
4. main path — the port's quickstart on the card, then Algorithm 1 (``>=``),
               the ring product and the ``normalize`` MRC at the paper's
               width (n = 137 15-bit moduli, 2**20 pairs) and on the
               quickstart base (n = 8, 2**22 pairs); verdicts are checked
               against the plain version on the card and against the host
               big-int oracle on 4096 sampled columns, and the kernels'
               launch counts against what the calls imply;
5. timing    — CUDA-event medians of each kernel and its plain version at
               the main-path shapes, beside the bound: the largest of bytes
               over 3.35 TB/s (H100 SXM data sheet) and, for each pipe
               (int32, conversion, fp32, load/store), the kernel's
               instructions on it over that pipe's peak rate;
6. kernels   — one line listing every ported kernel.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero with no ``ok`` line; so does a host without a CUDA device, or
a directory without the repository's ``src/``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
# Peak instructions per clock per SM for compute capability 9.0, by pipe:
# the CUDA C++ Programming Guide's arithmetic-throughput table (32-bit
# integer add/compare/multiply-add 64, conversions between 32-bit integer
# and float 16, fp32 128) and the SM's 32 load/store units (shared and
# global accesses alike).  Times the card's SM count and maximum SM clock,
# both read in this run, each gives that pipe's peak; at 132 SMs and
# 1.98 GHz the fp32 pipe with FMA counted twice is the data sheet's
# 67 TFLOP/s.
PIPE_PER_SM_CLOCK = {"int32": 64, "conversion": 16, "fp32": 128,
                     "load/store": 32}
# Instructions each unit of work issues, by pipe, counted from
# src/repro_torch/kernels/csrc/common.cuh.  Address arithmetic is not
# counted, so each pipe's count is a floor.
SUB_MOD = Counter({"int32": 3})             # a - b, compare, add m
# (a * b) mod m: product, f32 quotient (int->float, multiply, float->int),
# t - q*m, and the two corrections (compare and add each).  The SASS for
# sm_90a holds the int->float as I2FP, not the I2F that the 16-per-clock
# conversion rate is given for; it is counted on the int32 pipe, an
# assumption about its rate.  The float->int (F2I) is a conversion.
MUL_MOD = Counter({"int32": 7, "conversion": 1, "fp32": 1})
# One MRC step on the shared-memory column: SUB_MOD and MUL_MOD, plus
# loads of w_i, m_i and 1/m_i and a store of w_i (shared) and one load of
# the inverse (global, a warp-wide broadcast).
MRC_STEP = SUB_MOD + MUL_MOD + Counter({"load/store": 5})
ORACLE_COLUMNS = 4096
SWEEP_NS, SWEEP_BITS = (2, 3, 6, 17, 137), (8, 13, 15)
SWEEP_BATCHES = (1, 7, 300, 65537)
PAPER_BATCH, SMALL_BATCH = 1 << 20, 1 << 22
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def scaled(mix: Counter, k: int) -> Counter:
    return Counter({pipe: k * c for pipe, c in mix.items()})


def column_mix(name: str, n: int) -> Counter:
    """Instructions by pipe for one column (mrc, compare) or one element
    (modmul) of a kernel, as its source in csrc/ issues them."""
    steps = n * (n - 1) // 2
    if name == "modmul":   # x, y, m in, out; 1/m from an int->float (I2FP)
        return MUL_MOD + Counter({"load/store": 4, "int32": 1})
    mrc = scaled(MRC_STEP, steps) + Counter({"load/store": n - 1})  # w_j
    if name == "mrc":      # n loads and shared stores in, n shared loads and stores out
        return mrc + Counter({"load/store": 4 * n})
    # compare: n subtractions (x1, x2, m_i in, w_i out), the MRC, the dot
    # into m_a (w_i, beta_i, accumulate), its final reduction, and the
    # verdict (xa1, xa2 in, SUB_MOD, equality, out).
    return (scaled(SUB_MOD + Counter({"load/store": 4}), n) + mrc
            + scaled(MUL_MOD + Counter({"int32": 1, "load/store": 2}), n)
            + MUL_MOD - Counter({"int32": 1})
            + SUB_MOD + Counter({"int32": 2, "load/store": 3}))


# "/*0070*/  @!P0 IMAD.MOV.U32 R1, ..." -> "IMAD"
SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")


def sass_opcodes(library: str) -> dict:
    """Static SASS opcode counts of each kernel in the built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = next((k for k in ("mrc_kernel", "modmul_kernel", "compare_kernel")
                     if k in block.splitlines()[0]), None)
        if name is None:
            continue
        ops = re.findall(SASS_OPCODE, block)
        out[name] = dict(Counter(ops).most_common())
    require(len(out) == 3, f"cuobjdump found kernels {sorted(out)}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from repro_torch import quickstart
    from repro_torch.configs.paper_rns import make_paper_bases
    from repro_torch.core import Layout, RnsArray, backend, make_base, rns_to_int
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.modmul import modmul_kernel_call, modmul_plain
    from repro_torch.kernels.mrc import mrc_kernel_call, mrc_plain
    from repro_torch.kernels.ref import ref_compare, ref_modmul, ref_mrc
    from repro_torch.kernels.rns_compare import compare_kernel_call, compare_plain

    dev = torch.device(DEVICE, 0)
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # --------------------------------------------------------- 2. build
    info = build.build()
    build.load()
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "library": os.path.relpath(info["path"], ROOT), "ptxas": info["ptxas"],
          "sass_opcodes": sass_opcodes(info["path"])})

    # -------------------------------------------------------- 3. parity
    gen = torch.Generator(device=dev).manual_seed(0)

    def residues(base, shape, dtype=torch.int32):
        m = base.tensor("moduli_np", dev, torch.int64)
        r = torch.randint(0, 1 << 62, (*shape, base.n), generator=gen,
                          device=dev) % m
        return r.to(dtype)

    def tiles(x):
        return x.reshape(-1, x.shape[-1]).T.to(torch.int32).contiguous()

    max_err = {"mrc": 0, "modmul": 0, "compare": 0}

    def hold(name, got, want, where):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err[name] = max(max_err[name], err)
        require(got.shape == want.shape and err == 0,
                f"{name} kernel disagrees with its plain version at {where}")

    cases, skipped = 0, []
    for n in SWEEP_NS:
        for bits in SWEEP_BITS:
            try:
                base = make_base(n, bits=bits)
            except ValueError:          # e.g. 138 primes below 2**8 do not exist
                skipped.append({"n": n, "bits": bits})
                continue
            inv = base.tensor("inv_tri_np", dev, torch.int32)
            m = base.tensor("moduli_np", dev, torch.int32)
            betas = base.tensor("betas_ma_np", dev, torch.int32)
            for batch in SWEEP_BATCHES:
                for dtype in (torch.int32, torch.int64):
                    where = dict(n=n, bits=bits, batch=batch, dtype=str(dtype))
                    x1 = residues(base, (batch,), dtype)
                    x2 = residues(base, (batch,), dtype)
                    # mrc: wrapper (kernel) vs core plain, tile kernel vs tile plain
                    got = ops.mrc_op(base, x1)
                    require(got.dtype == dtype, f"mrc_op dtype at {where}")
                    hold("mrc", got, ref_mrc(base, x1), where)
                    hold("mrc", mrc_kernel_call(tiles(x1), inv, m),
                         mrc_plain(tiles(x1), inv, m), where)
                    # modmul
                    got = ops.modmul_op(base, x1, x2)
                    require(got.dtype == dtype, f"modmul_op dtype at {where}")
                    hold("modmul", got, ref_modmul(base, x1, x2), where)
                    worst = (m - 1).to(dtype).expand(batch, n)
                    hold("modmul", ops.modmul_op(base, worst, worst),
                         ref_modmul(base, worst, worst), dict(where, worst=True))
                    # compare, operands with m_a channels from the plain normalize
                    with backend("torch"):
                        A = RnsArray.from_parts(base, x1, device=dev).normalize(
                            Layout.BASE_MA)
                        B = RnsArray.from_parts(base, x2, device=dev).normalize(
                            Layout.BASE_MA)
                    got = ops.compare_op(A, B)
                    hold("compare", got, ref_compare(base, A.x, A.xa, B.x, B.xa),
                         where)
                    a1 = A.xa.to(torch.int32).contiguous()
                    a2 = B.xa.to(torch.int32).contiguous()
                    t1, t2 = tiles(A.x), tiles(B.x)
                    hold("compare",
                         compare_kernel_call(t1, a1, t2, a2, inv, m, betas, base.ma),
                         compare_plain(t1, a1, t2, a2, inv, m, betas, base.ma),
                         where)
                    # a self-comparison is always true: both branches covered
                    require(bool(ops.compare_op(A, A).all()), f"A >= A at {where}")
                    cases += 1
    torch.cuda.synchronize()
    emit({"phase": "parity", "cases": cases, "skipped": skipped,
          "max_abs_err": max_err, "exact": True})

    # ----------------------------------------------------- 4. main path
    def counts():
        return {"mrc": ops.mrc_op.launches, "modmul": ops.modmul_op.launches,
                "compare": ops.compare_op.launches}

    def delta(before):
        now = counts()
        return {k: now[k] - before[k] for k in now}

    ops.reset_launches()
    t0 = time.perf_counter()
    qs = quickstart.main(dev, verbose=False)
    torch.cuda.synchronize()
    got = counts()
    nbits = make_base(4, bits=8).M.bit_length()
    # quickstart's kernel calls: mrc — classic compare 2, to_int of q, r and
    # the scaled value 3, three halvings 3, two normalize 2; compare — step 3
    # 1, divmod 2*nbits+1, step 6 1; modmul — one per halving, 3
    want = {"mrc": 10, "modmul": 3, "compare": 2 * nbits + 3}
    require(got == want, f"quickstart launches {got}, expected {want}")
    emit({"phase": "main", "step": "quickstart", "seconds": time.perf_counter() - t0,
          "launches": got, "verdicts": int(qs["verdicts"].sum()),
          "batch": int(qs["verdicts"].size)})

    main_tiles = {}

    def width_run(label, base, batch):
        before = counts()
        t0 = time.perf_counter()
        x1 = residues(base, (batch,))
        x2 = residues(base, (batch,))
        A = RnsArray.from_parts(base, x1, device=dev).normalize(Layout.BASE_MA)
        B = RnsArray.from_parts(base, x2, device=dev).normalize(Layout.BASE_MA)
        ge = A >= B
        prod = A * B
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = delta(before)
        want = {"mrc": 2, "modmul": 1, "compare": 1}
        require(got == want, f"{label} launches {got}, expected {want}")
        # plain versions on the card, bit for bit
        with backend("torch"):
            A_p = RnsArray.from_parts(base, x1, device=dev).normalize(Layout.BASE_MA)
            require(torch.equal(A.residues, A_p.residues),
                    f"{label}: normalize differs from the plain route")
        require(torch.equal(ge, ref_compare(base, A.x, A.xa, B.x, B.xa)),
                f"{label}: >= differs from the plain version")
        red = base.tensor(("moduli_with", (base.ma,)), dev, torch.int32)
        want_prod = torch.remainder(A.residues * B.residues, red)
        require(torch.equal(prod.residues, want_prod),
                f"{label}: product differs from the plain version")
        # host big-int oracle on sampled columns
        cols = torch.randperm(batch, generator=gen, device=dev)[:ORACLE_COLUMNS]
        ax, bx = A.x[cols].cpu().numpy(), B.x[cols].cpu().numpy()
        aa, ba = A.xa[cols].cpu().numpy(), B.xa[cols].cpu().numpy()
        gs, px = ge[cols].cpu().numpy(), prod.residues[cols].cpu().numpy()
        for i in range(len(cols)):
            va, vb = rns_to_int(base, ax[i]), rns_to_int(base, bx[i])
            require(int(aa[i]) == va % base.ma and int(ba[i]) == vb % base.ma,
                    f"{label}: m_a channel differs from the oracle")
            require(bool(gs[i]) == (va >= vb), f"{label}: verdict differs "
                    "from the big-int oracle")
            require(rns_to_int(base, px[i][: base.n]) == va * vb % base.M
                    and int(px[i][base.n]) == va * vb % base.ma,
                    f"{label}: product differs from the big-int oracle")
        emit({"phase": "main", "step": label, "n": base.n, "batch": batch,
              "seconds": seconds, "launches": got, "true_share":
              float(ge.float().mean()), "oracle_columns": len(cols)})
        main_tiles[label] = (base, tiles(A.x), A.xa.to(torch.int32).contiguous(),
                             tiles(B.x), B.xa.to(torch.int32).contiguous(),
                             A.residues, B.residues, got)

    paper = make_paper_bases()[0]
    width_run("paper_n137", paper, PAPER_BATCH)
    width_run("quickstart_n8", make_base(8, bits=15), SMALL_BATCH)
    launches = counts()
    emit({"phase": "main", "step": "total", "launches": launches})

    # -------------------------------------------------------- 5. timing
    def median_ms(fn, runs=20, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(runs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])

    def bound(nbytes, mix, units):
        """Least time in ms: bytes over the memory rate, or the busiest
        pipe's instructions over its peak; and which one sets it."""
        ms = {pipe: 1e3 * units * count
              / (PIPE_PER_SM_CLOCK[pipe] * sms * clock_mhz * 1e6)
              for pipe, count in mix.items()}
        ms["bytes"] = 1e3 * nbytes / HBM_BYTES_PER_S
        pipe = max(ms, key=ms.get)
        return ms[pipe], "bytes" if pipe == "bytes" else "operations", pipe, ms

    timings = {}
    for label, (base, t1, a1, t2, a2, r1, r2, per_call) in main_tiles.items():
        n, B = t1.shape
        inv = base.tensor("inv_tri_np", dev, torch.int32)
        m = base.tensor("moduli_np", dev, torch.int32)
        betas = base.tensor("betas_ma_np", dev, torch.int32)
        mred = base.tensor(("moduli_with", (base.ma,)), dev, torch.int32)
        p1, p2 = tiles(r1), tiles(r2)
        # name: (kernel, plain version, bytes moved, units of work)
        work = {
            "mrc": (lambda: mrc_kernel_call(t1, inv, m),
                    lambda: mrc_plain(t1, inv, m),
                    8 * n * B + 4 * n * (n + 1), B),
            "modmul": (lambda: modmul_kernel_call(p1, p2, mred),
                       lambda: modmul_plain(p1, p2, mred),
                       12 * (n + 1) * B + 4 * (n + 1), (n + 1) * B),
            "compare": (lambda: compare_kernel_call(t1, a1, t2, a2, inv, m, betas,
                                                    base.ma),
                        lambda: compare_plain(t1, a1, t2, a2, inv, m, betas,
                                              base.ma),
                        8 * (n + 1) * B + 4 * B + 4 * n * (n + 2), B),
        }
        for name, (kern, plain, nbytes, units) in work.items():
            ms = median_ms(kern)
            plain_ms = median_ms(plain, runs=20, warmup=1)
            mix = column_mix(name, n)
            bound_ms, bound_by, pipe, pipe_ms = bound(nbytes, mix, units)
            row = {"phase": "timing", "kernel": name, "shape": label, "n": n,
                   "batch": B, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_pipe": pipe, "bound_share": bound_ms / ms,
                   "pipe_ms": pipe_ms, "bytes": nbytes,
                   "instructions": {p: units * c for p, c in mix.items()},
                   "sms": sms, "clock_max_mhz": clock_mhz,
                   "launches_per_call": per_call[name], "card": card}
            emit(row)
            timings[(name, label)] = row

    # ------------------------------------------------------- 6. kernels
    replaces = {"mrc": "src/repro/kernels/mrc.py:33",
                "modmul": "src/repro/kernels/modmul.py:26",
                "compare": "src/repro/kernels/rns_compare.py:44"}
    sources = {"mrc": "src/repro_torch/kernels/csrc/mrc.cu",
               "modmul": "src/repro_torch/kernels/csrc/modmul.cu",
               "compare": "src/repro_torch/kernels/csrc/rns_compare.cu"}
    rows = []
    for name in ("mrc", "modmul", "compare"):
        t = timings[(name, "paper_n137")]
        rows.append({"name": name, "route": "cuda", "source": sources[name],
                     "replaces": replaces[name], "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    require(all(r["launches"] > 0 for r in rows), "a kernel was never launched")
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
