#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (blobstreamx_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root. It prints one JSON line per phase, each
with ``wall_s``, the script's seconds when the phase ended:

  device        the card, and what nvidia-smi says of its power limit
  build         nvcc seconds for each kernel library, registers and spills
  kernel_check  each kernel against its plain PyTorch version on the card
                (exact equality: integer arithmetic), and its time at the
                main paths' shapes beside the plain version's; SHA-256 also
                against hashlib
  sha256_bench  ops.sha256.sha256_fixed_len, the entry point the TPU kernel
                served (bench.py's sha256_hashes_per_s): 2^15 messages of
                64 bytes hashed on the card, sampled rows against hashlib
  proof_small   the SHA-256 chip (256 rows) and the bytes chip as one system:
                proved on the card and with device="cpu" (plain versions),
                identical serde.dumps, verified, tamper probe rejected
  proof_full    the SHA-256 table of one production map job (734 compressions
                of SubchainMapCircuit(32), 2^16 rows) under the default
                StarkConfig: prove on the card, verify, tamper probe,
                digests against hashlib, kernel launches, peak memory
  profile       the same prove again under torch.profiler: device busy
                time, idle share, the top device kernels
  circuit_small DataCommitmentCircuit(max_leaves=2) over blocks 10000-10002
                proved on the card at a small config: the proof's SHA-256
                equals the recorded digest of the JAX package's proof, the
                root equals the recorded data commitment, verified, a
                flipped public byte rejected
  circuit_full  SubchainMapCircuit(32), the production map job of
                header_range_1024, over 10000-10004 under the default
                StarkConfig: witness, traces, prove (cpu 2^17, sha 2^16,
                bytes 256 rows), verify, tamper probe, the data root against
                the fixture, kernel launches, peak memory
  circuit_profile  that prove again under torch.profiler
  next_header_small, header_range_small
                NextHeaderCircuit(vss=2) at 10000 and HeaderRangeCircuit(vss=2,
                1, 4) over 10000-10004 on the recorded fixtures under the
                tests' config: each proof's SHA-256 equals its recorded
                digest (testing/reference_digests.py), verified
  header_range_full  HeaderRangeCircuit(vss=2, 1, 4) over 10000-10004 under
                the default StarkConfig (bench.py's shape): witness, traces,
                prove, verify, tamper probe on publics[80], the target hash and
                data commitment against the fixtures, launches, peak memory
  next_header_full  NextHeaderCircuit("mocha-4", vss=128) under the default
                StarkConfig over a synthetic chain of 128 validators
                (testing/synthetic.py, written to a temporary directory): the
                same fields, tamper probe on publics[40]
  recursion_small  the recursive verifier's outer circuit over the recorded
                proof of tests/test_recursion.py's tiny_inner circuit, at that
                test's config: the proof's SHA-256 equals the recorded digest
                of the JAX package's outer proof, verified
  reduce_full   MapReduceProver(batch_size=32, nb_map_jobs=2, succinct=True)
                .prove_succinct(10000, 10064) under the default StarkConfig
                over a synthetic chain of 64 blocks: two SubchainMapCircuit(32)
                proofs, then one ReduceCircuit (span 64) verifying both
                in-circuit; verify_succinct, a flipped data-commitment byte
                rejected, the root against the chain's data commitment; the
                reduce node's tables, phases, launches, peak memory
  reduce_profile  the reduce node's prove again under torch.profiler
  kernel_shapes every NTT and Poseidon call shape the three full phases gave
                the kernels: launches, time, bound, equality with the plain
                version (Poseidon leaves of more than 2^13 rows compared on
                their first and last 2^12 rows and one row of every block of
                the kernel's grid)

then the kernels line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failure exits non-zero without the ok line.
Exits non-zero before printing anything when no CUDA card is present. The
machine needs PyTorch with CUDA and nvcc; it needs no JAX.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
N_FULL = 1 << 16
# validator slots of next_header_full: the production registry's
# next_header at vss=128
NEXT_HEADER_VSS = 128
# Poseidon leaf hashes held against the plain version on this many rows at
# each end when taller (a row's digest depends on that row alone), and on
# one row of every block of the kernel's grid (csrc/poseidon.cu: kThreads
# rows a block)
POSEIDON_CHECK_ROWS = 1 << 12
POSEIDON_BLOCK_ROWS = 128
# reduce_full's synthetic chain: validators (a map job checks no signature)
# and the data-commitment ranges of its two map jobs and their root
REDUCE_VALIDATORS = 4
REDUCE_RANGES = ((10000, 10032), (10032, 10064), (10000, 10064))
# the prover's torch.profiler ranges (proof/system.py), a table each
PROVER_RANGES = ("logup_aux:", "constraint_sweep:")
# recorded mocha-4 chain data (headers, data commitments), read as JSON
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "blobstreamx_tpu", "fixtures", "mocha-4")

# Card rates for the bounds (NVIDIA H100 SXM data sheet and Hopper
# white paper): 3.35 TB/s of HBM3, and 132 SMs x 64 INT32 lanes x 1.98 GHz
# for 32-bit integer multiply-adds. A Goldilocks multiply is counted as the
# four 32x32-bit partial products of its 128-bit product, a lower bound
# that leaves out the reduction.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
IMAD_PER_MODMUL = 4
# Poseidon, the least multiplies of one permutation, in the sparse form the
# kernel runs (ops/poseidon.py:sparse_constants): 8 full rounds of 12
# S-boxes (4 multiplies each) and a 144-term MDS; the 11 x 11 matrix before
# the partial rounds (121); 22 partial rounds of one S-box and a sparse
# matrix (a row of 12, then 11 lanes of lane i += v_i * lane 0). The dense
# form counted 22 * (4 + 144) for the partial rounds, 4,792 in all.
MODMUL_PER_PERMUTATION = 8 * (12 * 4 + 144) + 121 + 22 * (4 + 12 + 11)
# SHA-256, the least 32-bit instructions of one compression, a 3-input xor
# or add counted as one: a round is 6 rotates, 2 xors, ch, maj and 4 adds
# (14); a schedule word 4 rotates and 2 shifts (sigma0 and sigma1 are two
# rotates and a shift each), 2 xors and 2 adds (10, 48 of them); then 8 adds
# into the state
SHA_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8


STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``wall_s`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields,
                      "wall_s": time.perf_counter() - STARTED}), flush=True)


def reset_counts():
    """Every kernel wrapper's launch count and launches by call shape to 0."""
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos
    from blobstreamx_tpu_torch.ops import sha256 as sha

    for wrapper in (nttmod.ntt_kernel, pos.permute_kernel, pos.hash_no_pad_kernel,
                    sha.sha256_fixed_len_kernel):
        wrapper.launches = 0
        wrapper.calls.clear()


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


def bound(bytes_moved: float, modmuls: float = 0, int32_ops: float = 0):
    """Least time on the card (ms) and what sets it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (modmuls * IMAD_PER_MODMUL + int32_ops) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def rand_field(torch, gl, rng, shape, dev):
    import numpy as np
    return gl.from_int(rng.integers(0, gl.P, size=shape, dtype=np.uint64), dev)


def card_field(torch, gen, shape, dev):
    """Field elements drawn on the card (a main-path shape may hold billions):
    (hi << 32) | lo with hi < 2^32 - 1, so every value is below p. The low
    halves are drawn a chunk at a time, so the draw needs little more
    memory than its result."""
    x = torch.randint(0, (1 << 32) - 1, shape, generator=gen, device=dev, dtype=torch.int64)
    x <<= 32
    flat = x.view(-1)
    for start in range(0, flat.numel(), 1 << 26):
        part = flat[start:start + (1 << 26)]
        part |= torch.randint(0, 1 << 32, part.shape, generator=gen, device=dev,
                              dtype=torch.int64)
    return x


def edge_field(torch, gl, rng, shape, dev):
    """Field elements drawn from values at the carry and borrow edges of the
    kernels' arithmetic (0, 1, p - 1, 2^32 - 1, 2^32, 2^63, ...)."""
    import numpy as np
    P = gl.P
    edges = np.array([0, 1, 2, P - 1, P - 2, 2**32 - 1, 2**32, 2**32 + 1, 2**63,
                      P - 2**32, 2**64 - 2**33, 2**31], dtype=np.uint64)
    return gl.from_int(edges[rng.integers(0, len(edges), size=shape)], dev)


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
    """Kernel time at every NTT shape of the full-size proves: the SHA-256
    table (111 main, 16 aux, 16 quotient columns; 2^16 rows, 2^19 LDE) and
    the map job's cpu table (5 main, 33 preprocessed, 38 aux, 16 quotient
    columns; 2^17 rows, 2^20 LDE). Each timed call is held exactly against
    the plain version on the same tensor; returns the rows and the largest
    error."""
    shapes = [("main interpolate", 111, 16, True), ("main LDE", 111, 19, False),
              ("aux interpolate", 16, 16, True), ("aux LDE", 16, 19, False),
              ("quotient interpolate", 2, 19, True), ("quotient chunks", 16, 16, False),
              ("FRI final", 2, 3, True),
              ("cpu main LDE", 5, 20, False), ("cpu pre LDE", 33, 20, False),
              ("cpu aux interpolate", 38, 17, True), ("cpu aux LDE", 38, 20, False),
              ("cpu quotient interpolate", 2, 20, True), ("cpu quotient chunks", 16, 17, False)]
    out, worst = [], 0.0
    for what, b, log_n, inverse in shapes:
        x = rand_field(torch, gl, rng, (b, 1 << log_n), dev)
        bound_ms, bound_by = ntt_bound(b, 1 << log_n)
        err = max_abs_err(torch, nttmod.ntt_kernel(x, inverse), nttmod.ntt_plain(x, inverse))
        worst = max(worst, err)
        out.append({"call": what, "shape": [b, 1 << log_n], "inverse": inverse,
                    "ms": cuda_ms(torch, lambda: nttmod.ntt_kernel(x, inverse), 5),
                    "bound_ms": bound_ms, "bound_by": bound_by, "equal_plain": err == 0})
    return out, worst


def ntt_bound(batch: int, n: int):
    """One read and one write of the batch; n/2 multiplies a stage."""
    return bound(2 * batch * n * 8, batch * (n // 2) * (n.bit_length() - 1))


def poseidon_bound(rows: int, width: int):
    """Leaf hash of (rows, width): read the rows, write 4-element digests;
    ceil(width / 8) permutations a row."""
    return bound(rows * (width + 4) * 8, rows * -(-width // 8) * MODMUL_PER_PERMUTATION)


def poseidon_main_path_ms(torch, gl, pos, rng, dev):
    """Kernel time at the Poseidon shapes of the full-size prove: leaf
    hashes of each LDE (rows read in place) and one Merkle level. Each
    timed call is held exactly against the plain version on the same
    tensor; returns the rows and the largest error. The main LDE's leaves
    (2^19 x 111) are timed and checked in phase_kernel_check."""
    out, worst = [], 0.0
    for what, rows, width, col_major in (
            ("aux leaves", 1 << 19, 16, True), ("pre leaves", 1 << 19, 21, True),
            ("FRI layer-0 leaves", 1 << 18, 4, True), ("cpu main leaves", 1 << 20, 5, True),
            ("cpu pre leaves", 1 << 20, 33, True), ("cpu aux leaves", 1 << 20, 38, True),
            ("cpu FRI layer-0 leaves", 1 << 19, 4, True),
            ("Merkle level (2^19 -> 2^18)", 1 << 18, 8, False)):
        m = rand_field(torch, gl, rng, (width, rows) if col_major else (rows, width), dev)
        leaves = m.t() if col_major else m
        bound_ms, bound_by = poseidon_bound(rows, width)
        err = max_abs_err(torch, pos.hash_no_pad_kernel(leaves), pos.hash_no_pad_plain(leaves))
        worst = max(worst, err)
        out.append({"call": what, "shape": [rows, width],
                    "ms": cuda_ms(torch, lambda: pos.hash_no_pad_kernel(leaves), 3),
                    "bound_ms": bound_ms, "bound_by": bound_by, "equal_plain": err == 0})
    return out, worst


def hashlib_rows(msgs, rows):
    """hashlib's digests of the chosen rows of a (B, L) uint8 numpy array."""
    return [hashlib.sha256(msgs[i].tobytes()).digest() for i in rows]


def sha256_check(torch, np, rng, dev):
    """The SHA-256 kernel against its plain version (torch.equal) and
    sampled rows against hashlib, at the bench shape, one block, three
    blocks and a ragged batch; then its time at 2^15 and 2^20 messages."""
    from blobstreamx_tpu_torch.ops import sha256 as sha

    cases, equal = [], True
    for B, L in ((1 << 15, 64), (130, 55), (64, 150), (1100, 64)):
        msgs = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
        x = torch.from_numpy(msgs).to(dev)
        got = sha.sha256_fixed_len_kernel(x)
        same = torch.equal(got, sha.sha256_fixed_len_plain(x))
        rows = sorted({0, B - 1, *rng.integers(0, B, size=14).tolist()})
        host = got.cpu().numpy()
        hl = all(bytes(host[i]) == d for i, d in zip(rows, hashlib_rows(msgs, rows)))
        cases.append({"B": B, "L": L, "equal_plain": same, "hashlib_rows": len(rows),
                      "equal_hashlib": hl})
        equal = equal and same and hl
    timed = {}
    for B in (1 << 15, 1 << 20):
        L = 64
        x = torch.from_numpy(rng.integers(0, 256, size=(B, L), dtype=np.uint8)).to(dev)
        ms = cuda_ms(torch, lambda: sha.sha256_fixed_len_kernel(x), 20)
        plain_ms = cuda_ms(torch, lambda: sha.sha256_fixed_len_plain(x), 2)
        n_blocks = (L + 8) // 64 + 1
        bound_ms, bound_by = bound(B * (L + 32), int32_ops=B * n_blocks * SHA_OPS_PER_BLOCK)
        timed[str(B)] = dict(shape=[B, L], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
    bench = timed[str(1 << 15)]
    return dict(max_abs_err=0.0 if equal else 1.0, ms=bench["ms"],
                plain_ms=bench["plain_ms"], bound_ms=bench["bound_ms"],
                bound_by=bench["bound_by"], shape=bench["shape"], cases=cases,
                timed=timed)


def phase_kernel_check(torch, np):
    from blobstreamx_tpu_torch.field import goldilocks as gl
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}

    # NTT: every size class and pass plan (one pass up to 2^12, one upper
    # pass from 2^13, a second from 2^21), both directions, batches of 1-3,
    # up to the reduce node's cpu LDE (2^24)
    ntt_err = 0.0
    ntt_cases = []
    for log_n in (1, 4, 10, 12, 13, 16, 17, 19, 20, 21, 22, 23, 24):
        batch = 1 + log_n % 3
        for make in (rand_field, edge_field):
            x = make(torch, gl, rng, (batch, 1 << log_n), dev)
            for inverse in (False, True):
                err = max_abs_err(torch, nttmod.ntt_kernel(x, inverse),
                                  nttmod.ntt_plain(x, inverse))
                ntt_err = max(ntt_err, err)
                ntt_cases.append({"n": 1 << log_n, "batch": batch, "inverse": inverse,
                                  "inputs": make.__name__, "passes": len(nttmod.plan(log_n)),
                                  "equal": err == 0})
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
    bound_ms, bound_by = ntt_bound(b, n)
    main_path, err = ntt_main_path_ms(torch, gl, nttmod, rng, dev)
    ntt_err = max(ntt_err, err)
    results["ntt"] = dict(max_abs_err=ntt_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          shape=[b, n], cases=ntt_cases, main_path_ms=main_path)

    # Poseidon: permutation batches, sponge layouts, and the python ints
    pos_err = 0.0
    for batch in (1, 2047, 2048, 65537):
        for make in (rand_field, edge_field):
            s = make(torch, gl, rng, (batch, 12), dev)
            pos_err = max(pos_err, max_abs_err(torch, pos.permute_kernel(s),
                                               pos.permute_plain(s)))
    for rows, width, col_major in ((4096, 111, True), (2048, 8, False), (300, 21, True)):
        for make in (rand_field, edge_field):
            m = make(torch, gl, rng, (width, rows) if col_major else (rows, width), dev)
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
    err = max_abs_err(torch, pos.hash_no_pad_kernel(x.t()), ref)
    pos_err = max(pos_err, err)
    bound_ms, bound_by = poseidon_bound(n, b)
    main_leaves = {"call": "main leaves", "shape": [n, b], "ms": ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "equal_plain": err == 0}
    del x, ref
    main_path, err = poseidon_main_path_ms(torch, gl, pos, rng, dev)
    pos_err = max(pos_err, err)
    results["poseidon"] = dict(max_abs_err=pos_err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               shape=[n, b], permute_py_equal=py_equal,
                               main_path_ms=[main_leaves] + main_path)
    results["sha256"] = sha256_check(torch, np, rng, dev)
    emit("kernel_check", **results)
    if ntt_err or pos_err or results["sha256"]["max_abs_err"]:
        raise SystemExit("a kernel disagrees with its plain version")
    return results


def phase_sha256_bench(torch, np):
    """The entry point at the bench shape, counts zeroed just before."""
    from blobstreamx_tpu_torch.ops import sha256 as sha

    msgs = np.random.default_rng(2).integers(0, 256, size=(1 << 15, 64), dtype=np.uint8)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    digests = sha.sha256_fixed_len(msgs)  # numpy in: hashed on the card
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = sha.sha256_fixed_len_kernel.launches
    host = digests.cpu().numpy()
    rows = list(range(0, 1 << 15, 1 << 11))
    ok = (digests.is_cuda and host.shape == (1 << 15, 32)
          and all(bytes(host[i]) == d for i, d in zip(rows, hashlib_rows(msgs, rows))))
    emit("sha256_bench", messages=1 << 15, length=64, launches=launches, seconds=seconds,
         hashlib_rows=len(rows), equal_hashlib=ok)
    if not (ok and launches):
        raise SystemExit("sha256_bench failed")
    return launches


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
    reset_counts()
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
    phase_profile(torch, "profile",
                  lambda: system.prove_system([spec], cfg, device=dev), prove_s)
    return launches


def phase_profile(torch, phase: str, prove, prove_s: float, host_s: float = 0.0,
                  ranges=()):
    """A second prove under torch.profiler: device busy time (the sum of
    the device events' times: one stream, so they do not overlap) against
    the unprofiled prove's wall time, and the top device kernels.
    ``host_s`` is the part of prove_s that is host-only work (witness and
    traces); ``ranges`` names prover ranges (proof/system.py) whose kernel
    launches are counted. The profiler's raw events are read directly: a
    circuit prove has millions, too many to turn into Python event trees.
    Every annotated range (the prover's record_function ranges among them)
    also shows on the device as an event as long as the range, under the
    range's name: device events named as a host event or as a prover range
    are left out of the device time and kernel count, whatever ``ranges``
    holds."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prove()
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    by_name = collections.defaultdict(lambda: [0, 0])  # name -> [ns, count]
    launch_starts, spans, host_names = [], [], set()
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            rec = by_name[name]
            rec[0] += e.duration_ns()
            rec[1] += 1
            continue
        host_names.add(name)
        if name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx"):
            launch_starts.append(e.start_ns())
        elif ranges and name.startswith(tuple(ranges)):
            spans.append((name, e.start_ns(), e.end_ns()))
    dropped = 0  # the device copies of host ranges
    for name in [k for k in by_name if k in host_names or k.startswith(PROVER_RANGES)]:
        dropped += by_name.pop(name)[1]
    launch_starts.sort()
    in_ranges = {}
    for name, start, end in spans:
        n = bisect.bisect_right(launch_starts, end) - bisect.bisect_left(launch_starts, start)
        in_ranges[name] = {"launches": n, "seconds": (end - start) / 1e9}
    rows = sorted(((k, ns / 1e3, c) for k, (ns, c) in by_name.items()), key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in rows) / 1e6
    ours = {name: {"device_s": sum(us for k, us, _ in rows if tag in k) / 1e6,
                   "launches": sum(c for k, _, c in rows if tag in k)}
            for name, tag in (("ntt", "ntt_"), ("poseidon", "poseidon_kernel"),
                              ("sha256", "sha256_kernel"))}
    emit(phase, device_busy_s=busy_s, prove_s_unprofiled=prove_s,
         device_idle_share=(1 - busy_s / prove_s) if busy_s else None,
         host_only_s=host_s,
         device_idle_share_without_host_only=(1 - busy_s / (prove_s - host_s))
         if busy_s else None,
         device_kernels=sum(c for _, _, c in rows), ours=ours,
         top=[{"kernel": k[:80], "device_s": us / 1e6, "count": c} for k, us, c in rows[:8]],
         device_annotations_left_out=dropped, ranges=in_ranges, traced_prove_s=traced_s,
         read_events_s=time.perf_counter() - t0)


def phase_circuit_small(torch, dev):
    """The smallest circuit on the card against the JAX package's proof,
    through its recorded digest (this machine has no JAX)."""
    from blobstreamx_tpu_torch.circuits.data_commitment import DataCommitmentCircuit
    from blobstreamx_tpu_torch.circuits.input import InputDataFetcher
    from blobstreamx_tpu_torch.proof import serde, stark
    from blobstreamx_tpu_torch.testing import reference_digests as refs

    ref = refs.DATA_COMMITMENT_2
    cfg = stark.StarkConfig(**ref["config"])
    start, end = ref["start_block"], ref["end_block"]
    fetcher = InputDataFetcher(FIXTURES)
    circuit = DataCommitmentCircuit(2, fetcher)
    t0 = time.perf_counter()
    proof, publics, root = circuit.prove(start, end, cfg, device=dev)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    text = serde.dumps(proof)
    digest = hashlib.sha256(text.encode()).hexdigest()
    root_ok = root == fetcher.get_data_commitment(start, end)
    t0 = time.perf_counter()
    ok = circuit.verify(serde.loads(text), publics, cfg, device=dev)
    verify_s = time.perf_counter() - t0
    bad = list(publics)
    bad[80] ^= 1  # first byte of the data commitment
    rejected = not circuit.verify(proof, bad, cfg, device=dev)
    emit("circuit_small", circuit=ref["circuit"], blocks=[start, end], config=ref["config"],
         proof_sha256=digest, reference_sha256=ref["proof_sha256"],
         equal_reference=digest == ref["proof_sha256"], root=root.hex(), root_ok=root_ok,
         verified=ok, tamper_rejected=rejected, prove_s=prove_s, verify_s=verify_s)
    if not (digest == ref["proof_sha256"] and root_ok and ok and rejected):
        raise SystemExit("circuit_small failed")


def phase_circuit_full(torch, np, dev, batch_size: int = 32, start: int = 10000,
                       end: int = 10004):
    """The production map job, proved end to end through the circuit's entry
    point under the default StarkConfig."""
    from blobstreamx_tpu_torch.circuits import map_job
    from blobstreamx_tpu_torch.circuits.input import InputDataFetcher
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos
    from blobstreamx_tpu_torch.ops import sha256 as sha
    from blobstreamx_tpu_torch.proof import serde, stark, system

    cfg = stark.StarkConfig()
    fetcher = InputDataFetcher(FIXTURES)
    t0 = time.perf_counter()
    job = map_job.SubchainMapCircuit(batch_size, fetcher)
    circuit = job.circuit
    build_s = time.perf_counter() - t0
    header = fetcher.get_header(end).hash()
    t0 = time.perf_counter()
    pks, vks = circuit.build_keys(cfg, dev)  # the preprocessed oracles: set-up
    torch.cuda.synchronize()
    keys_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timer = system.PhaseTimer()
    t0 = time.perf_counter()
    proof, publics = job.prove(start, end, header, cfg, pks=pks, device=dev, timer=timer)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {"ntt": nttmod.ntt_kernel.launches, "poseidon": pos.launches(),
                "sha256": sha.sha256_fixed_len_kernel.launches}
    peak = torch.cuda.max_memory_allocated()

    root = bytes(publics[map_job.OUT_DATA_ROOT])
    root_ok = root == fetcher.get_data_commitment(start, end)
    rows = {name: int(tp.n_rows) for name, tp in zip(circuit._table_names(), proof.table_proofs)}
    text = serde.dumps(proof)
    t0 = time.perf_counter()
    ok = job.verify(proof, publics, cfg, vks=vks, device=dev)
    verify_s = time.perf_counter() - t0
    bad = list(publics)
    bad[map_job.OUT_DATA_ROOT.start] ^= 1
    rejected = not job.verify(proof, bad, cfg, vks=vks, device=dev)
    phases = dict(timer.seconds)
    emit("circuit_full", circuit=f"SubchainMapCircuit({batch_size})", blocks=[start, end],
         config=vars(cfg), rows=rows, cpu_rows_used=len(circuit.b.rows),
         compressions=sum(len(c.blocks_word_wires) for c in circuit.b.sha_calls),
         sha_calls=len(circuit.b.sha_calls), build_s=build_s, keys_s=keys_s,
         witness_s=phases.get("witness"), traces_s=phases.get("traces"), prove_s=prove_s,
         system_prove_s=prove_s - phases.get("witness", 0) - phases.get("traces", 0),
         phases_s=phases, verify_s=verify_s, verified=ok, tamper_rejected=rejected,
         root=root.hex(), root_ok=root_ok, launches=launches, max_memory_allocated=peak,
         proof_json_bytes=len(text), proof_sha256=hashlib.sha256(text.encode()).hexdigest())
    if not (root_ok and ok and rejected and launches["ntt"] and launches["poseidon"]):
        raise SystemExit("circuit_full failed")
    phase_profile(torch, "circuit_profile",
                  lambda: job.prove(start, end, header, cfg, pks=pks, device=dev),
                  prove_s, host_s=phases.get("witness", 0) + phases.get("traces", 0))
    return launches


def poseidon_check_rows(torch, n: int, dev):
    """The rows of an n-row leaf hash held against the plain version: all of
    them up to 2 * POSEIDON_CHECK_ROWS, else both ends and one row of every
    block of the kernel's grid, at a lane that walks through the block."""
    if n <= 2 * POSEIDON_CHECK_ROWS:
        return torch.arange(n, device=dev)
    starts = torch.arange(0, n, POSEIDON_BLOCK_ROWS, device=dev)
    lanes = (torch.arange(starts.numel(), device=dev) * 37) % POSEIDON_BLOCK_ROWS
    return torch.cat([torch.arange(POSEIDON_CHECK_ROWS, device=dev),
                      (starts + lanes).clamp(max=n - 1),
                      torch.arange(n - POSEIDON_CHECK_ROWS, n, device=dev)]).unique()


def phase_kernel_shapes(torch, np, logs):
    """Every kernel call shape of the full phases: its launches a prove, the
    kernel's time and bound at that shape on random field elements, and
    exact equality with the plain version on the same tensor."""
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    rows_out, worst = [], 0.0
    shapes = sorted({key for log in logs.values() for key in log})
    for kind, shape, flag in shapes:
        launches = {path: log.get((kind, shape, flag), 0) for path, log in logs.items()}
        if kind == "ntt":
            x = card_field(torch, gen, shape, dev)
            err = max_abs_err(torch, nttmod.ntt_kernel(x, flag), nttmod.ntt_plain(x, flag))
            ms = cuda_ms(torch, lambda: nttmod.ntt_kernel(x, flag), 3)
            b = int(np.prod(shape[:-1]))
            bound_ms, bound_by = ntt_bound(b, shape[-1])
            checked = shape[0] if len(shape) > 1 else 1
        else:
            m = card_field(torch, gen, shape[::-1] if flag else shape, dev)
            leaves = m.t() if flag else m
            got = pos.hash_no_pad_kernel(leaves)
            idx = poseidon_check_rows(torch, shape[0], dev)
            err = max_abs_err(torch, got[idx], pos.hash_no_pad_plain(leaves[idx]))
            ms = cuda_ms(torch, lambda: pos.hash_no_pad_kernel(leaves), 3)
            bound_ms, bound_by = poseidon_bound(shape[0], shape[1])
            checked = idx.numel()
            del m, leaves, got
        worst = max(worst, err)
        rows_out.append({"kernel": kind, "shape": list(shape),
                         ("inverse" if kind == "ntt" else "col_major"): flag,
                         "launches": launches, "ms": ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "rows_checked": checked,
                         "equal_plain": err == 0})
        torch.cuda.empty_cache()
    emit("kernel_shapes", paths=sorted(logs), calls=rows_out, max_abs_err=worst)
    if worst:
        raise SystemExit("a kernel disagrees with its plain version at a main-path shape")


def tendermint_circuit(name: str, fetcher_dir: str, vss: int = 2):
    """The slice's two circuits: (circuit, prove args, public slices and
    their expected bytes, tamper byte)."""
    from blobstreamx_tpu_torch.circuits import input as pinput
    from blobstreamx_tpu_torch.circuits.header_range import HeaderRangeCircuit
    from blobstreamx_tpu_torch.circuits.next_header import NextHeaderCircuit

    if name == "next_header":
        fetcher = pinput.StepInputFetcher(fetcher_dir)
        circuit = NextHeaderCircuit(chain_id="mocha-4", vss=vss, fetcher=fetcher)
        expect = {"next_header_hash": (slice(40, 72), fetcher.get_header(10001).hash()),
                  "data_commitment": (slice(72, 104),
                                      fetcher.get_data_commitment(10000, 10001))}
        return circuit, (10000,), expect, 40
    fetcher = pinput.SkipInputFetcher(fetcher_dir)
    circuit = HeaderRangeCircuit(chain_id="mocha-4", vss=vss, nb_map_jobs=1, batch_size=4,
                                 fetcher=fetcher)
    expect = {"target_header_hash": (slice(48, 80), fetcher.get_header(10004).hash()),
              "data_commitment": (slice(80, 112), fetcher.get_data_commitment(10000, 10004))}
    return circuit, (10000, 10004), expect, 80


def phase_tendermint_small(torch, dev, name: str):
    """A slice circuit at vss=2 on the card against its recorded digest."""
    from blobstreamx_tpu_torch.proof import serde, stark
    from blobstreamx_tpu_torch.testing import reference_digests as refs

    ref = {"next_header": refs.NEXT_HEADER_2, "header_range": refs.HEADER_RANGE_2}[name]
    cfg = stark.StarkConfig(**ref["config"])
    circuit, args, expect, tamper_at = tendermint_circuit(name, FIXTURES)
    t0 = time.perf_counter()
    proof, publics, _, _ = circuit.prove(*args, cfg, device=dev)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    text = serde.dumps(proof)
    digest = hashlib.sha256(text.encode()).hexdigest()
    publics_ok = {k: bytes(publics[sl]) == v for k, (sl, v) in expect.items()}
    t0 = time.perf_counter()
    ok = circuit.verify(serde.loads(text), publics, cfg, device=dev)
    verify_s = time.perf_counter() - t0
    emit(f"{name}_small", circuit=ref["circuit"], config=ref["config"], proof_sha256=digest,
         reference_sha256=ref["proof_sha256"], reference_of=ref["reference_of"],
         equal_reference=digest == ref["proof_sha256"], publics_ok=publics_ok, verified=ok,
         prove_s=prove_s, verify_s=verify_s)
    if not (digest == ref["proof_sha256"] and all(publics_ok.values()) and ok):
        raise SystemExit(f"{name}_small failed")


def phase_tendermint_full(torch, np, dev, name: str, fetcher_dir: str, vss: int, note: str):
    """A slice circuit through its entry point under the default
    StarkConfig: witness, traces, prove, verify, tamper probe, public bytes
    against the chain's; kernel launches and call shapes, peak memory.
    Returns (launches, shape log, a prove for the profile)."""
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos
    from blobstreamx_tpu_torch.proof import serde, stark, system

    cfg = stark.StarkConfig()
    t0 = time.perf_counter()
    circuit, args, expect, tamper_at = tendermint_circuit(name, fetcher_dir, vss)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pks, vks = circuit.build_keys(cfg, dev)  # the preprocessed oracles: set-up
    torch.cuda.synchronize()
    keys_s = time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timer = system.PhaseTimer()
    t0 = time.perf_counter()
    proof, publics, _, _ = circuit.prove(*args, cfg, pks=pks, device=dev, timer=timer)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {"ntt": nttmod.ntt_kernel.launches, "poseidon": pos.launches()}
    calls = {("ntt",) + key: n for key, n in nttmod.ntt_kernel.calls.items()}
    calls.update({("poseidon",) + key: n for key, n in pos.hash_no_pad_kernel.calls.items()})
    peak = torch.cuda.max_memory_allocated()

    c = circuit.circuit
    rows = {t: int(tp.n_rows) for t, tp in zip(c._table_names(), proof.table_proofs)}
    widths = {t: air.width for t, air in zip(c._table_names(), c.airs())}
    publics_ok = {k: bytes(publics[sl]) == v for k, (sl, v) in expect.items()}
    text = serde.dumps(proof)
    t0 = time.perf_counter()
    ok = circuit.verify(proof, publics, cfg, vks=vks, device=dev)
    verify_s = time.perf_counter() - t0
    bad = list(publics)
    bad[tamper_at] ^= 1
    rejected = not circuit.verify(proof, bad, cfg, vks=vks, device=dev)
    phases = dict(timer.seconds)
    host_s = phases.get("witness", 0) + phases.get("traces", 0)
    emit(f"{name}_full", circuit=type(circuit).__name__, vss=vss, note=note,
         config=vars(cfg), rows=rows, widths=widths,
         ed_signatures=len(c.b.ed_calls), sha512_calls=len(c.b.sha512_calls),
         sha_calls=len(c.b.sha_calls), build_s=build_s, keys_s=keys_s,
         witness_s=phases.get("witness"), traces_s=phases.get("traces"), prove_s=prove_s,
         system_prove_s=prove_s - host_s, phases_s=phases, verify_s=verify_s, verified=ok,
         tamper_rejected=rejected, tamper_byte=tamper_at, publics_ok=publics_ok,
         launches=launches, max_memory_allocated=peak, proof_json_bytes=len(text),
         proof_sha256=hashlib.sha256(text.encode()).hexdigest())
    if not (ok and rejected and all(publics_ok.values()) and all(launches.values())):
        raise SystemExit(f"{name}_full failed")

    def again():
        return circuit.prove(*args, cfg, pks=pks, device=dev)

    return launches, calls, (again, prove_s, host_s)


def phase_recursion_small(torch, dev):
    """The recursive verifier's outer circuit over the recorded tiny_inner
    proof (tests/test_recursion.py's config), proved on the card against
    the recorded digest of the JAX package's outer proof: the first proof
    with a pos table."""
    from blobstreamx_tpu_torch.proof import recursion as rec
    from blobstreamx_tpu_torch.proof import serde, stark
    from blobstreamx_tpu_torch.testing import recursion as trec
    from blobstreamx_tpu_torch.testing import reference_digests as refs

    ref = refs.RECURSION_TINY
    cfg = stark.StarkConfig(**ref["config"])
    recorded = trec.load_tiny_inner()
    inner = trec.tiny_inner()
    inner_ok = inner.verify(recorded["proof"], recorded["publics"], cfg, device=dev)
    t0 = time.perf_counter()
    shapes = rec.inner_shapes(inner, cfg, dev)
    flat = rec.flatten_system_proof(recorded["proof"], shapes, cfg)
    outer = trec.outer_circuit(inner, recorded["publics"], flat, cfg, dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, publics = outer.prove({}, cfg, device=dev)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    text = serde.dumps(proof)
    digest = hashlib.sha256(text.encode()).hexdigest()
    t0 = time.perf_counter()
    ok = outer.verify(serde.loads(text), publics, cfg, device=dev)
    verify_s = time.perf_counter() - t0
    rows = {t: int(tp.n_rows) for t, tp in zip(outer._table_names(), proof.table_proofs)}
    emit("recursion_small", circuit=ref["circuit"], config=ref["config"], rows=rows,
         pos_permutations=len(outer.b.pos_perms), inner_verified=inner_ok,
         proof_sha256=digest, reference_sha256=ref["proof_sha256"],
         reference_of=ref["reference_of"], equal_reference=digest == ref["proof_sha256"],
         verified=ok, build_s=build_s, prove_s=prove_s, verify_s=verify_s)
    if not (inner_ok and ok and digest == ref["proof_sha256"]):
        raise SystemExit("recursion_small failed")


def launch_snapshot():
    """The NTT and Poseidon wrappers' launches and launches by call shape."""
    from blobstreamx_tpu_torch.field import ntt as nttmod
    from blobstreamx_tpu_torch.ops import poseidon as pos

    calls = collections.Counter({("ntt",) + k: n for k, n in nttmod.ntt_kernel.calls.items()})
    calls.update({("poseidon",) + k: n for k, n in pos.hash_no_pad_kernel.calls.items()})
    return {"ntt": nttmod.ntt_kernel.launches, "poseidon": pos.launches()}, calls


def phase_reduce_full(torch, np, dev, chain_dir: str):
    """The first level of production header_range's aggregation tree through
    MapReduceProver(batch_size=32, nb_map_jobs=2, succinct=True)
    .prove_succinct under the default StarkConfig: two SubchainMapCircuit(32)
    proofs over [10000, 10032) and [10032, 10064) of a synthetic chain, then
    one ReduceCircuit (span 64) that verifies both in-circuit. Verified by
    verify_succinct, a flipped data-commitment byte (in the claim and in the
    root's public bytes) rejected, the root against the chain's data
    commitment. Returns (path launches, reduce-node call shapes, profile)."""
    from blobstreamx_tpu_torch.circuits import map_job
    from blobstreamx_tpu_torch.circuits.input import InputDataFetcher
    from blobstreamx_tpu_torch.parallel import mapreduce
    from blobstreamx_tpu_torch.proof import serde, stark, system

    start, end, batch = 10000, 10064, 32
    cfg = stark.StarkConfig()
    fetcher = InputDataFetcher(chain_dir)
    t0 = time.perf_counter()
    prover = mapreduce.MapReduceProver(
        batch_size=batch, nb_map_jobs=2, fetcher=fetcher, cfg=cfg, succinct=True,
        checkpoint_dir=os.path.join(chain_dir, "checkpoints"), device=dev)
    map_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (node,) = prover.reduce_templates()  # commits the children's preprocessed caps
    torch.cuda.synchronize()
    reduce_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pks, vks = node.build_keys(cfg, dev)  # the reduce node's oracles: set-up
    torch.cuda.synchronize()
    keys_s = time.perf_counter() - t0

    class Timer(system.PhaseTimer):
        """Notes the launch counts where the reduce node's prove begins."""
        at_node = None

        def mark(self, name, device):
            if name == "witness" and self.at_node is None:
                self.at_node = launch_snapshot()
            super().mark(name, device)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timer = Timer()
    t0 = time.perf_counter()
    agg = prover.prove_succinct(start, end, timer=timer)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches, calls = launch_snapshot()
    node_launches = {k: v - timer.at_node[0][k] for k, v in launches.items()}
    node_calls = calls - timer.at_node[1]
    peak = torch.cuda.max_memory_allocated()
    phases = dict(timer.seconds)
    map_jobs_s = phases.pop("map_jobs")
    host_s = phases.get("witness", 0) + phases.get("traces", 0)
    node_prove_s = path_s - map_jobs_s

    c = node.circuit
    proof = agg.root_proof
    rows = {t: int(tp.n_rows) for t, tp in zip(c._table_names(), proof.table_proofs)}
    widths = {t: [air.width, air.pre_width] for t, air in zip(c._table_names(), c.airs())}
    pb = bytes(agg.root_publics)
    expect = fetcher.get_data_commitment(start, end)
    root_ok = agg.data_commitment == expect and pb[map_job.OUT_DATA_ROOT] == expect
    start_header = fetcher.get_header(start).hash()
    t0 = time.perf_counter()
    ok = prover.verify_succinct(agg, start_header=start_header)
    verify_s = time.perf_counter() - t0
    flipped = bytearray(pb)
    flipped[map_job.OUT_DATA_ROOT.start] ^= 1
    bad = mapreduce.SuccinctProof(**{**vars(agg), "root_publics": list(flipped),
                                     "data_commitment": bytes(flipped[map_job.OUT_DATA_ROOT])})
    rejected = not prover.verify_succinct(bad, start_header=start_header)
    text = serde.dumps(proof)
    emit("reduce_full", circuit="ReduceCircuit(span=64) over 2 x SubchainMapCircuit(32)",
         entry_point="MapReduceProver(batch_size=32, nb_map_jobs=2, succinct=True)"
                     ".prove_succinct", blocks=[start, end], config=vars(cfg), rows=rows,
         widths=widths, cpu_rows_used=len(c.b.rows), pos_permutations=len(c.b.pos_perms),
         map_build_s=map_build_s, reduce_build_s=reduce_build_s, keys_s=keys_s,
         map_jobs_s=map_jobs_s, witness_s=phases.get("witness"),
         traces_s=phases.get("traces"), prove_s=node_prove_s,
         system_prove_s=node_prove_s - host_s, phases_s=phases, path_s=path_s,
         verify_s=verify_s, verified=ok, tamper_rejected=rejected, root=expect.hex(),
         root_ok=root_ok, start_header_ok=pb[map_job.OUT_START_HEADER] == start_header,
         launches=launches, node_launches=node_launches, max_memory_allocated=peak,
         proof_json_bytes=len(text), proof_sha256=hashlib.sha256(text.encode()).hexdigest())
    if not (ok and rejected and root_ok and all(node_launches.values())):
        raise SystemExit("reduce_full failed")

    leaves = []
    for j in range(2):
        with open(prover._ckpt_path(start + j * batch, end, agg.global_end_header)) as f:
            d = json.load(f)
        leaves.append((serde.system_proof_from_json(d["proof"]), d["publics"]))

    def again():
        return node.prove(start, end, agg.global_end_header, leaves[0], leaves[1], cfg,
                          pks, dev)

    return launches, dict(node_calls), (again, node_prove_s, host_s)


def synthetic_chain(tmp: str, n_validators: int, n_blocks: int = 1,
                    ranges=((10000, 10001),)) -> str:
    """A chain of signed blocks 10000 .. 10000 + n_blocks with
    ``n_validators`` validators and the data commitments of ``ranges``,
    deterministic from the generator's fixed seed tag."""
    from blobstreamx_tpu_torch.testing import synthetic

    t0 = time.perf_counter()
    synthetic.make_chain_dir(tmp, chain_id="mocha-4", n_validators=n_validators,
                             start=10000, n_blocks=n_blocks, ranges=list(ranges))
    emit("synthetic_chain", validators=n_validators, heights=[10000, 10000 + n_blocks],
         ranges=list(ranges), seconds=time.perf_counter() - t0)
    return tmp


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
    paths = {"sha256_bench": {"sha256": phase_sha256_bench(torch, np)}}
    phase_proof_small(torch, np, dev)
    paths["proof_full"] = phase_proof_full(torch, np, dev)
    phase_circuit_small(torch, dev)
    paths["circuit_full"] = phase_circuit_full(torch, np, dev)
    phase_tendermint_small(torch, dev, "next_header")
    phase_tendermint_small(torch, dev, "header_range")
    phase_recursion_small(torch, dev)
    shape_logs = {}
    paths["header_range_full"], shape_logs["header_range_full"], _ = phase_tendermint_full(
        torch, np, dev, "header_range", FIXTURES, 2, "bench.py's shape, recorded fixtures")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        chain = synthetic_chain(tmp, NEXT_HEADER_VSS)
        paths["next_header_full"], shape_logs["next_header_full"], _ = \
            phase_tendermint_full(torch, np, dev, "next_header", chain, NEXT_HEADER_VSS,
                                  f"{NEXT_HEADER_VSS} synthetic validators, all signing")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        chain = synthetic_chain(tmp, REDUCE_VALIDATORS, n_blocks=64, ranges=REDUCE_RANGES)
        paths["reduce_full"], shape_logs["reduce_full"], again = \
            phase_reduce_full(torch, np, dev, chain)
        prove, prove_s, host_s = again
        phase_profile(torch, "reduce_profile", prove, prove_s, host_s=host_s,
                      ranges=PROVER_RANGES)
        del prove, again
    torch.cuda.empty_cache()
    phase_kernel_shapes(torch, np, shape_logs)
    # each kernel's launches on this slice's path: succinct aggregation of
    # two map jobs for the NTT and Poseidon, the bench entry point for SHA-256
    main = {"ntt": "reduce_full", "poseidon": "reduce_full", "sha256": "sha256_bench"}
    table = []
    for name, replaces in (("ntt", "blobstreamx_tpu/ops/pallas/ntt.py:78"),
                           ("poseidon", "blobstreamx_tpu/ops/pallas/poseidon.py:113"),
                           ("sha256", "blobstreamx_tpu/ops/pallas/sha256.py:40")):
        c = checks[name]
        table.append({"name": name, "route": "cuda",
                      "source": f"blobstreamx_tpu_torch/csrc/{name}.cu",
                      "replaces": replaces, "launches": paths[main[name]][name],
                      "launches_by_path": {p: l.get(name, 0) for p, l in paths.items()},
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
