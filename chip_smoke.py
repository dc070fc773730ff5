#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (blobstreamx_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root. It prints one JSON line per phase:

  device        the card, and what nvidia-smi says of its power limit
  build         nvcc seconds for each kernel library, registers and spills
  kernel_check  each kernel against its plain PyTorch version on the card
                (exact equality: integer field arithmetic), and its time at
                the prover's full-size shapes beside the plain version's
  proof_small   the SHA-256 chip (256 rows) and the bytes chip as one system:
                proved on the card and with device="cpu" (plain versions),
                identical serde.dumps, verified, tamper probe rejected
  proof_full    the SHA-256 table of one production map job (734 compressions
                of SubchainMapCircuit(32), 2^16 rows) under the default
                StarkConfig: prove on the card, verify, tamper probe,
                digests against hashlib, kernel launches, peak memory
  profile       the same prove again under torch.profiler: device busy
                time, idle share, the top device kernels

then the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failure exits non-zero without the ok line.
Exits non-zero before printing anything when no CUDA card is present. The
machine needs PyTorch with CUDA and nvcc; it needs no JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

SEED = 0
N_FULL = 1 << 16

# Card rates for the bounds (NVIDIA H100 SXM data sheet and Hopper
# white paper): 3.35 TB/s of HBM3, and 132 SMs x 64 INT32 lanes x 1.98 GHz
# for 32-bit integer multiply-adds. A Goldilocks multiply is counted as the
# four 32x32-bit partial products of its 128-bit product, a lower bound
# that leaves out the reduction.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
IMAD_PER_MODMUL = 4
# Poseidon: 8 full rounds of 12 S-boxes (4 multiplies each) and a 144-term
# MDS, 22 partial rounds of one S-box and the MDS
MODMUL_PER_PERMUTATION = 8 * (12 * 4 + 144) + 22 * (4 + 144)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def bound(bytes_moved: float, modmuls: float):
    """Least time on the card (ms) and what sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = modmuls * IMAD_PER_MODMUL / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def rand_field(torch, gl, rng, shape, dev):
    import numpy as np
    return gl.from_int(rng.integers(0, gl.P, size=shape, dtype=np.uint64), dev)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=line,
         torch=torch.__version__, cuda=torch.version.cuda)
    return line


def phase_build(kernels):
    seconds = kernels.build_all()
    ptxas = {name: [l.strip() for l in kernels.build_log(name).splitlines()
                    if "registers" in l or "spill" in l]
             for name in kernels.SOURCES}
    emit("build", seconds=seconds, ptxas=ptxas)


def ntt_main_path_ms(torch, gl, nttmod, rng, dev):
    """Kernel time at every NTT shape of the full-size prove (the SHA-256
    table: 111 main, 16 aux, 16 quotient columns; 2^16 rows, 2^19 LDE)."""
    shapes = [("main interpolate", 111, 16, True), ("main LDE", 111, 19, False),
              ("aux interpolate", 16, 16, True), ("aux LDE", 16, 19, False),
              ("quotient interpolate", 2, 19, True), ("quotient chunks", 16, 16, False),
              ("FRI final", 2, 3, True)]
    out = []
    for what, b, log_n, inverse in shapes:
        x = rand_field(torch, gl, rng, (b, 1 << log_n), dev)
        out.append({"call": what, "shape": [b, 1 << log_n], "inverse": inverse,
                    "ms": cuda_ms(torch, lambda: nttmod.ntt_kernel(x, inverse), 5)})
    return out


def poseidon_main_path_ms(torch, gl, pos, rng, dev):
    """Kernel time at the Poseidon shapes of the full-size prove: leaf
    hashes of each LDE (rows read in place) and one Merkle level."""
    out = []
    for what, rows, width in (("main leaves", 1 << 19, 111), ("aux leaves", 1 << 19, 16),
                              ("pre leaves", 1 << 19, 21), ("FRI layer-0 leaves", 1 << 18, 4)):
        m = rand_field(torch, gl, rng, (width, rows), dev)
        out.append({"call": what, "shape": [rows, width],
                    "ms": cuda_ms(torch, lambda: pos.hash_no_pad_kernel(m.t()), 3)})
    level = rand_field(torch, gl, rng, (1 << 18, 8), dev)
    out.append({"call": "Merkle level (2^19 -> 2^18)", "shape": [1 << 18, 8],
                "ms": cuda_ms(torch, lambda: pos.hash_no_pad_kernel(level), 5)})
    return out


def phase_kernel_check(torch, np):
    from blobstreamx_tpu_torch.field import goldilocks as gl
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}

    # NTT: every size class, both directions, a batch of 3
    ntt_err = 0.0
    ntt_cases = []
    for log_n in (4, 10, 12, 16, 19):
        x = rand_field(torch, gl, rng, (3, 1 << log_n), dev)
        for inverse in (False, True):
            err = max_abs_err(torch, nttmod.ntt_kernel(x, inverse),
                              nttmod.ntt_plain(x, inverse))
            ntt_err = max(ntt_err, err)
            ntt_cases.append({"n": 1 << log_n, "inverse": inverse, "equal": err == 0})
    # the main path's largest shape: the main trace LDE, 111 columns at 2^19
    x = rand_field(torch, gl, rng, (111, 1 << 19), dev)
    ms = cuda_ms(torch, lambda: nttmod.ntt_kernel(x), 10)
    t0 = time.perf_counter()
    ref = nttmod.ntt_plain(x)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ntt_err = max(ntt_err, max_abs_err(torch, nttmod.ntt_kernel(x), ref))
    del ref
    b, n = x.shape
    bound_ms, bound_by = bound(2 * b * n * 8, b * (n // 2) * 19)
    results["ntt"] = dict(max_abs_err=ntt_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          shape=[b, n], cases=ntt_cases,
                          main_path_ms=ntt_main_path_ms(torch, gl, nttmod, rng, dev))

    # Poseidon: permutation batches, sponge layouts, and the python ints
    pos_err = 0.0
    for batch in (1, 2047, 2048, 65537):
        s = rand_field(torch, gl, rng, (batch, 12), dev)
        pos_err = max(pos_err, max_abs_err(torch, pos.permute_kernel(s),
                                           pos.permute_plain(s)))
    for rows, width, col_major in ((4096, 111, True), (2048, 8, False), (300, 21, True)):
        m = rand_field(torch, gl, rng, (width, rows) if col_major else (rows, width), dev)
        leaves = m.t() if col_major else m
        pos_err = max(pos_err, max_abs_err(torch, pos.hash_no_pad_kernel(leaves),
                                           pos.hash_no_pad_plain(leaves)))
    states = rng.integers(0, gl.P, size=(4, 12), dtype=np.uint64)
    got = gl.to_int(pos.permute_kernel(gl.from_int(states, dev)))
    py_equal = all([int(v) for v in got[i]] == pos.permute_py([int(v) for v in states[i]])
                   for i in range(4))
    if not py_equal:
        pos_err = max(pos_err, 1.0)
    # the main path's largest shape: leaf hashes of the main LDE rows
    ms = cuda_ms(torch, lambda: pos.hash_no_pad_kernel(x.t()), 3)
    t0 = time.perf_counter()
    ref = pos.hash_no_pad_plain(x.t())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pos_err = max(pos_err, max_abs_err(torch, pos.hash_no_pad_kernel(x.t()), ref))
    perms = n * -(-b // pos.RATE)
    bound_ms, bound_by = bound(n * (b + pos.DIGEST) * 8, perms * MODMUL_PER_PERMUTATION)
    results["poseidon"] = dict(max_abs_err=pos_err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               shape=[n, b], permute_py_equal=py_equal,
                               main_path_ms=poseidon_main_path_ms(torch, gl, pos, rng, dev))
    emit("kernel_check", **results)
    if ntt_err or pos_err:
        raise SystemExit("a kernel disagrees with its plain version")
    return results


def sha_public_messages(ch, messages_bytes, blocks):
    """The verifier's bus messages: +message words, -digest words, the
    digests taken from hashlib."""
    import numpy as np
    pubs = []
    for inst, blks in enumerate(blocks):
        for blk_i, blk in enumerate(np.asarray(blks, dtype=np.uint32)):
            for slot in range(16):
                pubs.append((ch.SHA_W, [inst, blk_i, slot, int(blk[slot])], +1))
    for inst, data in enumerate(messages_bytes):
        d = hashlib.sha256(data).digest()
        words = [int.from_bytes(d[4 * i:4 * i + 4], "big") for i in range(8)]
        for j in range(4):
            pubs.append((ch.SHA_OUT_A, [inst, j, words[j]], -1))
            pubs.append((ch.SHA_OUT_E, [inst, j, words[4 + j]], -1))
    return pubs


def tamper_digest(pubs):
    bad = list(pubs)
    chan, args, sign = bad[-1]
    bad[-1] = (chan, [args[0], args[1], (args[2] + 1) % (1 << 32)], sign)
    return bad


def phase_proof_small(torch, np, dev):
    from blobstreamx_tpu_torch.chips import bytes as bytes_chip
    from blobstreamx_tpu_torch.chips import channels as ch
    from blobstreamx_tpu_torch.chips import sha256 as chip
    from blobstreamx_tpu_torch.ops import sha256 as sha
    from blobstreamx_tpu_torch.proof import serde, stark, system

    cfg = stark.StarkConfig(rate_bits=3, cap_height=1, num_query_rounds=8,
                            pow_bits=4, final_poly_bits=2)
    data = [b"abc", b"a" * 100]
    blocks = [sha.pad_message(m) for m in data]
    sched = chip.schedule_for(blocks, 256)
    sha_air = chip.Sha256Air(sched, 256)
    trace = chip.build_trace(blocks, 256, sched)
    counts = np.random.default_rng(SEED).integers(0, 3, size=256).astype(np.uint64)
    specs = [system.TableSpec("sha", sha_air, trace, []),
             system.TableSpec("bytes", bytes_chip.BytesAir(), bytes_chip.build_trace(counts), [])]
    sha_pubs = sha_public_messages(ch, data, blocks)
    range_pubs = [(ch.RANGE8, [v], +1) for v in range(256) for _ in range(int(counts[v]))]
    pubs = sha_pubs + range_pubs

    t0 = time.perf_counter()
    card = serde.dumps(system.prove_system(specs, cfg, device=dev))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = serde.dumps(system.prove_system(specs, cfg, device="cpu"))
    cpu_s = time.perf_counter() - t0
    airs = [s.air for s in specs]
    proof = serde.loads(card)
    ok = system.verify_system(airs, [[], []], proof, cfg, public_messages=pubs, device=dev)
    rejected = not system.verify_system(airs, [[], []], proof, cfg,
                                        public_messages=tamper_digest(sha_pubs) + range_pubs,
                                        device=dev)
    identical = card == host
    emit("proof_small", identical=identical,
         sha256_card=hashlib.sha256(card.encode()).hexdigest(),
         sha256_cpu=hashlib.sha256(host.encode()).hexdigest(),
         verified=ok, tamper_rejected=rejected, prove_card_s=card_s, prove_cpu_s=cpu_s)
    if not (identical and ok and rejected):
        raise SystemExit("proof_small failed")


def map_job_messages(rng, n_blocks: int = 32):
    """The SHA-256 inputs of one SubchainMapCircuit(n_blocks) map job: per
    block a 35-byte data_hash leaf and 4 inner nodes, a 73-byte
    last_block_id leaf and 4 inner nodes, a 65-byte data-root-tuple leaf;
    then the n_blocks - 1 inner nodes of the tuple tree. Inner nodes are 65
    bytes. For 32 blocks: 383 messages, 734 compressions."""
    lengths = []
    for _ in range(n_blocks):
        lengths += [35] + [65] * 4 + [73] + [65] * 4 + [65]
    lengths += [65] * (n_blocks - 1)
    return [rng.bytes(n) for n in lengths]


def phase_proof_full(torch, np, dev, n_rows: int = N_FULL, n_blocks: int = 32):
    from blobstreamx_tpu_torch.chips import channels as ch
    from blobstreamx_tpu_torch.chips import sha256 as chip
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos
    from blobstreamx_tpu_torch.ops import sha256 as sha
    from blobstreamx_tpu_torch.proof import serde, stark, system

    cfg = stark.StarkConfig()
    rng = np.random.default_rng(SEED)
    data = map_job_messages(rng, n_blocks)
    blocks = [sha.pad_message(m) for m in data]
    n_comp = sum(len(b) for b in blocks)
    t0 = time.perf_counter()
    sched = chip.schedule_for(blocks, n_rows)
    air = chip.Sha256Air(sched, n_rows)
    trace = chip.build_trace(blocks, n_rows, sched)
    witness_s = time.perf_counter() - t0

    # digests in the trace (final-block output rows) against hashlib
    checked = 0
    for s, seg in enumerate(sched):
        if seg.real and seg.is_last and seg.inst % 16 == 0:
            base = s * chip.SEGMENT
            words = [0] * 8
            for i in range(4):
                words[3 - i] = int(trace[base + 64 + i, chip.COL_OUT_A])
                words[7 - i] = int(trace[base + 64 + i, chip.COL_OUT_E])
            got = b"".join(w.to_bytes(4, "big") for w in words)
            if got != hashlib.sha256(data[seg.inst]).digest():
                raise SystemExit(f"digest of message {seg.inst} disagrees with hashlib")
            checked += 1

    spec = system.TableSpec("sha", air, trace, [])
    stark.build(air, n_rows, cfg, dev)  # the preprocessed oracle: set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nttmod.ntt_kernel.launches = 0
    pos.permute_kernel.launches = 0
    pos.hash_no_pad_kernel.launches = 0
    timer = system.PhaseTimer()
    t0 = time.perf_counter()
    proof = system.prove_system([spec], cfg, device=dev, timer=timer)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {"ntt": nttmod.ntt_kernel.launches, "poseidon": pos.launches()}
    peak = torch.cuda.max_memory_allocated()

    pubs = sha_public_messages(ch, data, blocks)
    t0 = time.perf_counter()
    ok = system.verify_system([air], [[]], proof, cfg, public_messages=pubs, device=dev)
    verify_s = time.perf_counter() - t0
    rejected = not system.verify_system([air], [[]], proof, cfg,
                                        public_messages=tamper_digest(pubs), device=dev)
    text = serde.dumps(proof)
    emit("proof_full", rows=n_rows, compressions=n_comp, messages=len(data),
         config=vars(cfg), witness_s=witness_s, prove_s=prove_s,
         phases_s=timer.seconds, verify_s=verify_s, verified=ok,
         tamper_rejected=rejected, digests_checked=checked, launches=launches,
         max_memory_allocated=peak, proof_json_bytes=len(text),
         proof_sha256=hashlib.sha256(text.encode()).hexdigest())
    if not (ok and rejected and all(launches.values())):
        raise SystemExit("proof_full failed")
    if dev.type == "cuda":
        phase_profile(torch, spec, cfg, dev, prove_s)
    return launches


def phase_profile(torch, spec, cfg, dev, prove_s: float):
    """A second prove of the full table under torch.profiler: device busy
    time (the sum of kernel times: one stream, so they do not overlap)
    against the unprofiled prove's wall time, and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from blobstreamx_tpu_torch.proof import system

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        system.prove_system([spec], cfg, device=dev)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # CPU ops also carry their kernels' time
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us, e.count))
    busy_s = sum(us for _, us, _ in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    ours = {name: {"device_s": sum(us for k, us, _ in rows if tag in k) / 1e6,
                   "launches": sum(c for k, _, c in rows if tag in k)}
            for name, tag in (("ntt", "ntt_"), ("poseidon", "poseidon_kernel"))}
    emit("profile", device_busy_s=busy_s, prove_s_unprofiled=prove_s,
         device_idle_share=(1 - busy_s / prove_s) if busy_s else None,
         device_kernels=sum(c for _, _, c in rows), ours=ours,
         top=[{"kernel": k[:80], "device_s": us / 1e6, "count": c} for k, us, c in rows[:8]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from blobstreamx_tpu_torch import kernels

    torch.manual_seed(SEED)
    smi_line = phase_device(torch)
    phase_build(kernels)
    checks = phase_kernel_check(torch, np)
    dev = torch.device("cuda")
    phase_proof_small(torch, np, dev)
    launches = phase_proof_full(torch, np, dev)
    table = []
    for name, replaces in (("ntt", "blobstreamx_tpu/ops/pallas/ntt.py:78"),
                           ("poseidon", "blobstreamx_tpu/ops/pallas/poseidon.py:113")):
        c = checks[name]
        table.append({"name": name, "route": "cuda",
                      "source": f"blobstreamx_tpu_torch/csrc/{name}.cu",
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                      "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
