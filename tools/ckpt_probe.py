#!/usr/bin/env python3
"""What one full-width checkpoint costs the host of a card: disk, memory and
the rates of the steps a save and a restore take.

    python3 tools/ckpt_probe.py [--gb 4] [--dir DIR]

Prints the card's name and power limit (``nvidia-smi``), then one JSON
object: the free and total bytes of the file system under DIR (default
``_ckpt_probe/`` in the repository root, git-ignored, removed at the end)
and of the temporary directory, ``MemAvailable``, the CPU count; the
sustained rate of writing a ``--gb`` GB file in 64 MiB blocks and fsyncing
it, of reading it back after its pages were dropped from the page cache
(``posix_fadvise(DONTNEED)``) and of reading it again from the cache;
sha256 over 1 GiB, on one thread and on four at once; the card's copy
rates to the host into pageable and into pinned memory; and the device
rate of the checkpoint's residue encode (int64 ``remainder`` by five
15-bit moduli) and of numpy's uint32 ``remainder`` on the host.
Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 64 << 20
MODULI = (32749, 32719, 32717, 32713, 32707)


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def disk(path: str) -> dict:
    u = shutil.disk_usage(path)
    return {"path": path, "free": u.free, "total": u.total}


def file_rates(path: str, nbytes: int) -> dict:
    import numpy as np

    buf = np.random.default_rng(0).integers(
        0, 255, BLOCK, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(nbytes // BLOCK):
            f.write(buf)
        t_written = time.perf_counter()
        f.flush()
        os.fsync(f.fileno())
    t1 = time.perf_counter()
    fd = os.open(path, os.O_RDONLY)
    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    os.close(fd)
    into = bytearray(BLOCK)
    rates = {"write_s": t_written - t0, "write_fsync_s": t1 - t0}
    for label in ("read_cold", "read_cached"):
        t = time.perf_counter()
        with open(path, "rb", buffering=0) as f:
            while f.readinto(into):
                pass
        rates[label + "_s"] = time.perf_counter() - t
    os.remove(path)
    gb = nbytes / 1e9
    rates.update(bytes=nbytes,
                 write_fsync_gb_per_s=gb / rates["write_fsync_s"],
                 read_cold_gb_per_s=gb / rates["read_cold_s"],
                 read_cached_gb_per_s=gb / rates["read_cached_s"])
    return rates


def sha_rates() -> dict:
    import numpy as np

    data = np.random.default_rng(1).integers(0, 255, 1 << 30,
                                             dtype=np.uint8)
    t = time.perf_counter()
    hashlib.sha256(memoryview(data)).hexdigest()
    one = (1 << 30) / (time.perf_counter() - t) / 1e9
    threads = [threading.Thread(
        target=lambda: hashlib.sha256(memoryview(data)).hexdigest())
        for _ in range(4)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    four = 4 * (1 << 30) / (time.perf_counter() - t) / 1e9
    return {"sha256_gb_per_s_one_thread": one,
            "sha256_gb_per_s_four_threads": four}


def card_rates() -> dict:
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    n = 1 << 28                                  # 1 GiB of int32
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), dtype=torch.int32,
                      device=dev)
    out = {}
    for label, host in (("pageable", torch.empty(n, dtype=torch.int32)),
                        ("pinned", torch.empty(n, dtype=torch.int32,
                                               pin_memory=True))):
        host.copy_(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        host.copy_(x)
        torch.cuda.synchronize()
        out[f"d2h_{label}_gb_per_s"] = 4 * n / (time.perf_counter() - t) / 1e9
    chunk = 1 << 24

    def encode():
        for a in range(0, n, chunk):
            q = x[a:a + chunk].to(torch.int64) & 0xFFFFFFFF
            for m in MODULI:
                torch.remainder(q, m).to(torch.int32)

    encode()
    torch.cuda.synchronize()
    t = time.perf_counter()
    encode()
    torch.cuda.synchronize()
    out["device_encode_limbs_per_s"] = n / (time.perf_counter() - t)
    q = np.random.default_rng(2).integers(0, 1 << 32, 1 << 24,
                                          dtype=np.uint64).astype(np.uint32)
    t = time.perf_counter()
    for m in MODULI:
        np.remainder(q, np.uint32(m))
    out["host_numpy_encode_limbs_per_s"] = q.size / (time.perf_counter() - t)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gb", type=float, default=4.0)
    ap.add_argument("--dir", default=os.path.join(ROOT, "_ckpt_probe"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ckpt_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    os.makedirs(args.dir, exist_ok=True)
    try:
        report = {"disk": disk(args.dir),
                  "tmp_disk": disk(tempfile.gettempdir()),
                  "mem_available": mem_available(),
                  "cpus": os.cpu_count()}
        nbytes = int(args.gb * 1e9) // BLOCK * BLOCK
        report["file"] = file_rates(os.path.join(args.dir, "probe.bin"),
                                    nbytes)
        report.update(sha_rates())
        report.update(card_rates())
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
