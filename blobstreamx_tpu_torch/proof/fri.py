"""FRI low-degree proofs over GF(p^2): folds and layer commitments on the
prover's device, transcript and verification on the host.

Counterpart of ``blobstreamx_tpu/proof/fri.py``. Values live on the coset
``shift * K`` of the order-N subgroup K in natural order (x_i = shift *
w^i), so -x_i sits at index i + N/2 and a fold halves the domain in place.
Extension values are (N, 2) int64 tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from ..field import goldilocks as gl
from ..field import ntt as nttmod
from ..field import extension as ext
from . import merkle_cap
from .transcript import Transcript

INV2 = pow(2, gl.P - 2, gl.P)


@dataclass
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 2
    num_query_rounds: int = 28
    pow_bits: int = 8
    final_poly_bits: int = 3  # stop folding at domain size 2^final_poly_bits


@dataclass
class FriQueryStep:
    pair_values: List[Tuple[int, int]]  # [v(x), v(-x)] extension values
    siblings: List[list]  # digests of 4 python ints, leaf level upwards


@dataclass
class FriProof:
    caps: List[list]
    final_coeffs: List[Tuple[int, int]]
    pow_nonce: int
    query_rounds: List[List[FriQueryStep]]


def _layer_domain(log_n: int, log_layer: int) -> tuple:
    """(shift, w) of the layer with domain size 2^(log_n - log_layer)."""
    shift = pow(gl.GENERATOR, 1 << log_layer, gl.P)
    w = gl.primitive_root_of_unity(log_n - log_layer)
    return shift, w


@functools.lru_cache(maxsize=None)
def _inv_x(log_n: int, log_layer: int, device) -> torch.Tensor:
    """(half,) tensor of 1/x_i for the first half of the layer's domain."""
    shift, w = _layer_domain(log_n, log_layer)
    half = 1 << (log_n - log_layer - 1)
    s_inv = pow(shift, gl.P - 2, gl.P)
    w_inv = pow(w, gl.P - 2, gl.P)
    return gl.mul(gl.powers(w_inv, half, device), gl.scalar(s_inv, device))


def _fold(values: torch.Tensor, beta, log_n: int, log_layer: int) -> torch.Tensor:
    """One arity-2 fold: (n, 2) -> (n/2, 2).

    v'(x^2) = (v(x) + v(-x))/2 + beta * (v(x) - v(-x)) / (2x)
    """
    half = values.shape[0] // 2
    dev = values.device
    a, b = values[:half], values[half:]
    s_plus = ext.add(a, b)
    s_minus = ext.sub(a, b)
    term = ext.mul(ext.scalar_mul(s_minus, _inv_x(log_n, log_layer, dev)),
                   ext.from_int_pair(beta, dev))
    return ext.scalar_mul(ext.add(s_plus, term), gl.scalar(INV2, dev))


def _pair_leaves(values: torch.Tensor) -> torch.Tensor:
    """(n, 2) ext values -> (n/2, 4) leaf rows [v(x) || v(-x)]."""
    half = values.shape[0] // 2
    return torch.cat([values[:half], values[half:]], dim=1)


def _coset_intt_ext(values: torch.Tensor, shift: int) -> List[Tuple[int, int]]:
    """Ext evals on shift*K -> list of ext coefficients (python ints)."""
    n = values.shape[0]
    coeffs = nttmod.ntt(values.t(), inverse=True, device=values.device)  # (2, n)
    s_inv = pow(shift, gl.P - 2, gl.P)
    coeffs = gl.mul(coeffs, gl.powers(s_inv, n, values.device))
    c = gl.to_int(coeffs)
    return [(int(c[0, i]), int(c[1, i])) for i in range(n)]


def grind(transcript: Transcript, pow_bits: int) -> int:
    """Proof-of-work: the first nonce whose challenge has pow_bits leading
    zeros (2^pow_bits permutations expected, on the host)."""
    nonce = 0
    while not check_grind(transcript, nonce, pow_bits):
        nonce += 1
    return nonce


def check_grind(transcript: Transcript, nonce: int, pow_bits: int) -> bool:
    t = transcript.fork()
    t.observe_element(nonce)
    return t.get_challenge() >> (64 - pow_bits) == 0


def fri_prove(values: torch.Tensor, transcript: Transcript, cfg: FriConfig):
    """Prove that ``values`` (N, 2) on coset g*K has degree < N >> rate_bits.

    Returns (FriProof, query_indices): callers open their outer oracles at
    the same indices."""
    N = values.shape[0]
    log_n = N.bit_length() - 1
    if 1 << log_n != N:
        raise ValueError(f"FRI domain {N} is not a power of two")

    trees: List[merkle_cap.MerkleTree] = []
    layer_leaves: List[torch.Tensor] = []
    cur = values
    log_layer = 0
    while cur.shape[0] > (1 << cfg.final_poly_bits):
        leaves = _pair_leaves(cur)
        cap_k = min(cfg.cap_height, leaves.shape[0].bit_length() - 1)
        tree = merkle_cap.build_tree(leaves, cap_k)
        transcript.observe_cap(tree.cap_ints())
        beta = transcript.get_extension_challenge()
        trees.append(tree)
        layer_leaves.append(leaves)
        cur = _fold(cur, beta, log_n, log_layer)
        log_layer += 1

    final_shift = pow(gl.GENERATOR, 1 << log_layer, gl.P)
    final_len = max(1, cur.shape[0] >> cfg.rate_bits)
    final_coeffs = _coset_intt_ext(cur, final_shift)[:final_len]
    # for an honest prover the truncated tail is zero; soundness comes from
    # the verifier evaluating only the truncated polynomial
    for c in final_coeffs:
        transcript.observe_extension(c)

    nonce = grind(transcript, cfg.pow_bits)
    transcript.observe_element(nonce)
    indices = transcript.get_indices(cfg.num_query_rounds, log_n)

    # gather every queried leaf row of a layer in one copy
    positions = []
    n = N
    idx = list(indices)
    for _ in trees:
        half = n // 2
        idx = [i % half for i in idx]
        positions.append(idx)
        n = half
    rows = [gl.to_int(leaves[torch.tensor(pos, device=leaves.device)])
            for leaves, pos in zip(layer_leaves, positions)]

    query_rounds = []
    for qi in range(len(indices)):
        steps = []
        for k, tree in enumerate(trees):
            row = [int(v) for v in rows[k][qi]]
            steps.append(FriQueryStep(
                pair_values=[(row[0], row[1]), (row[2], row[3])],
                siblings=tree.open(positions[k][qi]),
            ))
        query_rounds.append(steps)

    proof = FriProof(
        caps=[t.cap_ints() for t in trees],
        final_coeffs=final_coeffs,
        pow_nonce=nonce,
        query_rounds=query_rounds,
    )
    return proof, indices


def fri_verify(
    proof: FriProof,
    log_n: int,
    transcript: Transcript,
    cfg: FriConfig,
    eval_at_index: Callable[[int, int], Optional[Tuple[int, int]]],
) -> bool:
    """Verify. ``eval_at_index(round_i, q)`` returns the claimed layer-0
    extension value at domain index q (derived from outer oracle openings,
    which the callback must itself merkle-verify), or None on failure."""
    N = 1 << log_n
    betas = []
    for cap in proof.caps:
        transcript.observe_cap(cap)
        betas.append(transcript.get_extension_challenge())
    n_layers = len(proof.caps)
    final_size = N >> n_layers
    if final_size != (1 << cfg.final_poly_bits):
        return False
    if len(proof.final_coeffs) != max(1, final_size >> cfg.rate_bits):
        return False
    for c in proof.final_coeffs:
        transcript.observe_extension(c)
    if not check_grind(transcript, proof.pow_nonce, cfg.pow_bits):
        return False
    transcript.observe_element(proof.pow_nonce)
    indices = transcript.get_indices(cfg.num_query_rounds, log_n)
    if len(proof.query_rounds) != len(indices):
        return False

    F2 = ext.GFp2
    for round_i, (q, steps) in enumerate(zip(indices, proof.query_rounds)):
        if len(steps) != n_layers:
            return False
        v = eval_at_index(round_i, q)
        if v is None:
            return False
        n = N
        idx = q
        for k, step in enumerate(steps):
            half = n // 2
            p = idx % half
            pos_in_pair = idx // half
            row = [(int(a), int(b)) for a, b in step.pair_values]
            if len(row) != 2 or row[pos_in_pair] != (int(v[0]), int(v[1])):
                return False
            flat = [x for pair in row for x in pair]
            if not merkle_cap.verify_opening(flat, p, step.siblings, proof.caps[k]):
                return False
            shift, w = _layer_domain(log_n, k)
            x = (shift * pow(w, p, gl.P)) % gl.P
            v0, v1 = row
            s_plus = F2.add(v0, v1)
            s_minus = F2.sub(v0, v1)
            inv_x = pow(x, gl.P - 2, gl.P)
            term = F2.mul(betas[k], F2.mul(s_minus, (inv_x, 0)))
            v = F2.mul(F2.add(s_plus, term), (INV2, 0))
            idx = p
            n = half
        # final check: v == final_poly(x) on the final domain
        shift_f = pow(gl.GENERATOR, 1 << n_layers, gl.P)
        w_f = gl.primitive_root_of_unity(log_n - n_layers)
        xf = (shift_f * pow(w_f, idx, gl.P)) % gl.P
        acc = (0, 0)
        for c in reversed(proof.final_coeffs):
            acc = F2.add(F2.mul(acc, (xf, 0)), (int(c[0]), int(c[1])))
        if acc != v:
            return False
    return True
