#!/usr/bin/env python3
"""Time the port's NTT and Poseidon kernels of several source trees on one
CUDA card, in turns, at the map-job prove's shapes.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (the repository root, or an unpacked
``git archive`` of another commit). The trees are measured in the order
given, each in a process of its own that imports ``blobstreamx_tpu_torch``
from that tree and builds its kernels there, so list them as
parent, change, change, parent to compare two commits. Every tree gets the
same inputs (numpy, seed 0); the SHA-256 of each kernel's outputs is
printed beside its time, so equal digests across trees show that the
kernels compute the same function. One JSON line per tree, then the
card's name and power limit. Needs a CUDA card and nvcc; no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

NTT_SHAPES = [("main LDE", 111, 19, False), ("main interpolate", 111, 16, True),
              ("aux LDE", 16, 19, False), ("quotient interpolate", 2, 19, True),
              ("cpu main LDE", 5, 20, False), ("cpu aux LDE", 38, 20, False),
              ("cpu aux interpolate", 38, 17, True), ("cpu quotient chunks", 16, 17, False)]
POSEIDON_SHAPES = [("main leaves", 1 << 19, 111, True), ("aux leaves", 1 << 19, 16, True),
                   ("cpu aux leaves", 1 << 20, 38, True), ("cpu main leaves", 1 << 20, 5, True),
                   ("FRI layer-0 leaves", 1 << 18, 4, True),
                   ("Merkle level (2^19 -> 2^18)", 1 << 18, 8, False)]


def cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(torch, fn, iters: int) -> dict:
    """Device time a call, by CUDA kernel name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            name = re.search(r"(\w+)\(", e.key)
            out[name.group(1) if name else e.key[:40]] = us / 1e3 / iters
    return out


def measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.field import ntt
    from blobstreamx_tpu_torch.ops import poseidon as pos

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    if not os.path.dirname(kernels.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"kernel_ab: imported {kernels.__file__}, not {tree}'s package")
    kernels.build_all(("ntt", "poseidon"))
    ptxas = {name: [l.strip() for l in kernels.build_log(name).splitlines()
                    if "registers" in l or "spill" in l] for name in ("ntt", "poseidon")}
    rng = np.random.default_rng(0)
    P = 0xFFFFFFFF00000001

    def field(shape):
        u = rng.integers(0, P, size=shape, dtype=np.uint64)
        return torch.from_numpy(u.view(np.int64)).cuda()

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    rows = []
    for what, b, log_n, inverse in NTT_SHAPES:
        x = field((b, 1 << log_n))
        rows.append({"kernel": "ntt", "call": what, "shape": [b, 1 << log_n],
                     "inverse": inverse, "ms": cuda_ms(torch, lambda: ntt.ntt_kernel(x, inverse), 10),
                     "device_ms_by_kernel": device_ms_by_kernel(
                         torch, lambda: ntt.ntt_kernel(x, inverse), 5),
                     "out_sha256": digest(ntt.ntt_kernel(x, inverse))})
        del x
    for what, n, width, col_major in POSEIDON_SHAPES:
        m = field((width, n) if col_major else (n, width))
        leaves = m.t() if col_major else m
        rows.append({"kernel": "poseidon", "call": what, "shape": [n, width],
                     "ms": cuda_ms(torch, lambda: pos.hash_no_pad_kernel(leaves), 5),
                     "out_sha256": digest(pos.hash_no_pad_kernel(leaves))})
        del m, leaves
    return {"tree": tree, "ptxas": ptxas, "rows": rows}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    trees = sys.argv[1:]
    if not trees:
        raise SystemExit(__doc__)
    results = []
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree],
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            raise SystemExit(f"kernel_ab: {tree} failed ({out.returncode})")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    same = all(len({r["rows"][i]["out_sha256"] for r in results}) == 1
               for i in range(len(results[0]["rows"])))
    print(json.dumps({"outputs_equal_across_trees": same}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
