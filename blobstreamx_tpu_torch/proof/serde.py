"""Proof (de)serialization to the JSON of ``blobstreamx_tpu/proof/serde.py``.

The port's dataclasses hold python ints; the JSON keeps the JAX package's
field layout, where a digest or a FRI leaf value is written as [lo, hi]
u32 limb pairs. So ``dumps`` of a port proof equals ``dumps`` of the
reference's proof on the same inputs, byte for byte.
"""

from __future__ import annotations

import json

from . import fri, stark, system

_M32 = 0xFFFFFFFF


def _limbs(v: int) -> list:
    return [int(v) & _M32, int(v) >> 32]


def _from_limbs(pair) -> int:
    return int(pair[0]) | (int(pair[1]) << 32)


def _digest_to_json(d) -> list:
    return [_limbs(v) for v in d]


def _digest_from_json(d) -> list:
    return [_from_limbs(p) for p in d]


# -- FRI ---------------------------------------------------------------------

def _fri_proof_to_json(p: fri.FriProof) -> dict:
    return {
        "caps": p.caps,
        "final_coeffs": [list(c) for c in p.final_coeffs],
        "pow_nonce": p.pow_nonce,
        "query_rounds": [
            [
                {
                    "pair_values": [[_limbs(c) for c in v] for v in s.pair_values],
                    "siblings": [_digest_to_json(x) for x in s.siblings],
                }
                for s in round_
            ]
            for round_ in p.query_rounds
        ],
    }


def _fri_proof_from_json(d: dict) -> fri.FriProof:
    return fri.FriProof(
        caps=d["caps"],
        final_coeffs=[tuple(c) for c in d["final_coeffs"]],
        pow_nonce=d["pow_nonce"],
        query_rounds=[
            [
                fri.FriQueryStep(
                    pair_values=[tuple(_from_limbs(c) for c in v) for v in s["pair_values"]],
                    siblings=[_digest_from_json(x) for x in s["siblings"]],
                )
                for s in round_
            ]
            for round_ in d["query_rounds"]
        ],
    )


# -- STARK -------------------------------------------------------------------

def _opened_row_to_json(r: stark.OpenedRow) -> dict:
    return {"values": r.values, "siblings": [_digest_to_json(s) for s in r.siblings]}


def _opened_row_from_json(d: dict) -> stark.OpenedRow:
    return stark.OpenedRow(values=d["values"],
                           siblings=[_digest_from_json(s) for s in d["siblings"]])


def _openings_to_json(openings) -> dict:
    return {str(k): [list(v) for v in vals] for k, vals in openings.items()}


def _openings_from_json(d: dict) -> dict:
    return {int(k): [tuple(v) for v in vals] for k, vals in d.items()}


def stark_proof_to_json(p: stark.StarkProof) -> dict:
    return {
        "n_rows": p.n_rows,
        "main_cap": p.main_cap,
        "aux_cap": p.aux_cap,
        "quotient_cap": p.quotient_cap,
        "main_openings": _openings_to_json(p.main_openings),
        "aux_openings": _openings_to_json(p.aux_openings),
        "pre_openings": _openings_to_json(p.pre_openings),
        "quotient_zeta": [list(v) for v in p.quotient_zeta],
        "fri_proof": _fri_proof_to_json(p.fri_proof),
        "query_openings": [
            {k: _opened_row_to_json(v) for k, v in entry.items()}
            for entry in p.query_openings
        ],
    }


def stark_proof_from_json(d: dict) -> stark.StarkProof:
    return stark.StarkProof(
        n_rows=d["n_rows"],
        main_cap=d["main_cap"],
        aux_cap=d["aux_cap"],
        quotient_cap=d["quotient_cap"],
        main_openings=_openings_from_json(d["main_openings"]),
        aux_openings=_openings_from_json(d["aux_openings"]),
        pre_openings=_openings_from_json(d["pre_openings"]),
        quotient_zeta=[tuple(v) for v in d["quotient_zeta"]],
        fri_proof=_fri_proof_from_json(d["fri_proof"]),
        query_openings=[
            {k: _opened_row_from_json(v) for k, v in entry.items()}
            for entry in d["query_openings"]
        ],
    )


# -- system ------------------------------------------------------------------

def system_proof_to_json(p: system.SystemProof) -> dict:
    return {
        "table_proofs": [stark_proof_to_json(tp) for tp in p.table_proofs],
        "bus_totals": [list(t) if t is not None else None for t in p.bus_totals],
    }


def system_proof_from_json(d: dict) -> system.SystemProof:
    return system.SystemProof(
        table_proofs=[stark_proof_from_json(tp) for tp in d["table_proofs"]],
        bus_totals=[tuple(t) if t is not None else None for t in d["bus_totals"]],
    )


def dumps(p: system.SystemProof) -> str:
    return json.dumps(system_proof_to_json(p))


def loads(s: str) -> system.SystemProof:
    return system_proof_from_json(json.loads(s))
