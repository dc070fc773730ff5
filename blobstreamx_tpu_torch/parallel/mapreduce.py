"""MapReduce proving over a block range: map jobs, then a reduce tree.

The port's copy of ``blobstreamx_tpu/parallel/mapreduce.py``.

  * **map**: each batch of ``batch_size`` blocks is proved as an
    independent ``SubchainMapCircuit`` STARK (circuits/map_job.py), on the
    prover's device.
  * **transparent reduce** (``prove`` / ``verify``): the linkage checks and
    the sha256(0x01‖l‖r) root combination are recomputed by the verifier
    from the leaf proofs' public values; the artifact carries every leaf
    proof.
  * **succinct reduce** (``prove_succinct`` / ``verify_succinct``): a tree
    of ``ReduceCircuit``s (circuits/aggregate.py) verifies the children
    in-circuit, so the result is one proof whose statement covers the
    whole range.
  * **checkpoint/resume**: every completed leaf proof is written
    (proof/serde.py JSON) keyed by (batch_start, global context); a
    restarted prover reloads and re-verifies checkpointed leaves instead of
    proving them again.

Divergences from the reference: the map jobs are proved one after
another on one torch device, in place of the reference's thread pool over
``jax.default_device`` (its ``max_workers`` knob is gone); the fetcher is
always wrapped in the prefetcher (its ``prefetch`` flag is gone); the
reduce templates are built at first use, on the prover's device; only jobs
without a checkpoint file are announced to the prefetcher, and its
unclaimed fetches are released at the end of every prove
(parallel/prefetch.py).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .. import device as devmod
from ..circuits.input import InputDataFetcher
from ..circuits.map_job import (
    IN_BYTES, OUT_DATA_ROOT, OUT_END_HEADER, OUT_START_HEADER,
    SubchainMapCircuit,
)
from ..proof import serde
from .prefetch import PrefetchingFetcher

log = logging.getLogger("blobstreamx_tpu_torch.mapreduce")


@dataclass
class LeafProof:
    job: int
    batch_start: int
    publics: List[int]
    proof: object  # SystemProof


@dataclass
class MapReduceProof:
    """Transparent aggregate: the proof forest and the claimed statement."""

    start_block: int
    end_block: int
    batch_size: int
    global_end_header: bytes
    leaves: List[LeafProof]
    data_commitment: bytes


@dataclass
class SuccinctProof:
    """Succinct aggregate: one root proof whose statement covers the whole
    range; its verification cost does not grow with nb_map_jobs."""

    start_block: int
    end_block: int
    batch_size: int
    nb_map_jobs: int
    global_end_header: bytes
    data_commitment: bytes
    root_proof: object       # SystemProof of the top ReduceCircuit
    root_publics: List[int]  # its 144 public bytes


@dataclass
class _Subchain:
    """Host mirror of the reduce walk's subchain."""

    is_enabled: bool
    start_block: int
    start_header: bytes
    end_block: int
    end_header: bytes
    data_merkle_root: bytes


def _inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def _leaf_to_subchain(leaf: LeafProof, batch_size: int, global_end: int) -> _Subchain:
    pb = bytes(leaf.publics)
    batch_start = int.from_bytes(pb[0:8], "big")
    end_block = max(batch_start, min(batch_start + batch_size, global_end))
    return _Subchain(
        is_enabled=batch_start < global_end,
        start_block=batch_start,
        start_header=pb[OUT_START_HEADER],
        end_block=end_block,
        end_header=pb[OUT_END_HEADER],
        data_merkle_root=pb[OUT_DATA_ROOT],
    )


def _reduce(left: _Subchain, right: _Subchain) -> _Subchain:
    """The reduce rule, replayed on the host by prover and verifier."""
    if right.is_enabled:
        if left.end_header != right.start_header:
            raise ValueError("subchain headers not linked")
        if left.end_block != right.start_block:
            raise ValueError("subchain blocks not linked")
        root = _inner_hash(left.data_merkle_root, right.data_merkle_root)
        return _Subchain(left.is_enabled, left.start_block, left.start_header,
                         right.end_block, right.end_header, root)
    return left


def _reduce_tree(subchains: Sequence[_Subchain]) -> _Subchain:
    level = list(subchains)
    while len(level) > 1:
        assert len(level) % 2 == 0
        level = [_reduce(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


class MapReduceProver:
    """Schedules map-job proofs, reduces them, checkpoints.

    nb_map_jobs × batch_size plays the role of the reference's
    NB_MAP_JOBS × BATCH_SIZE const generics. Proofs run on ``device`` (None:
    the card)."""

    def __init__(self, batch_size: int, nb_map_jobs: int,
                 fetcher: InputDataFetcher, cfg=None,
                 checkpoint_dir: Optional[str] = None,
                 succinct: bool = False, device=None):
        assert nb_map_jobs & (nb_map_jobs - 1) == 0, "power-of-two tree"
        self.batch_size = batch_size
        self.nb_map_jobs = nb_map_jobs
        self.fetcher = PrefetchingFetcher(fetcher)
        self.cfg = cfg
        self.checkpoint_dir = checkpoint_dir
        self.device = device
        self.template = SubchainMapCircuit(batch_size, self.fetcher)
        self.succinct = succinct
        self._reduce_templates: Optional[list] = None

    def reduce_templates(self) -> list:
        """One ReduceCircuit a tree level (level L verifies two level-(L-1)
        proofs in-circuit), built at first use on the prover's device."""
        if self._reduce_templates is None:
            from ..circuits.aggregate import ReduceCircuit

            templates = []
            child = self.template.circuit
            span = self.batch_size * 2
            while span <= self.batch_size * self.nb_map_jobs and self.nb_map_jobs > 1:
                rc = ReduceCircuit(child, span, self.cfg, self.device)
                templates.append(rc)
                child = rc.circuit
                span *= 2
            self._reduce_templates = templates
        return self._reduce_templates

    # -- checkpointing ------------------------------------------------------

    def _ckpt_path(self, batch_start: int, global_end: int,
                   global_end_header: bytes) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        key = hashlib.sha256(
            f"{self.batch_size}:{batch_start}:{global_end}:".encode()
            + global_end_header
        ).hexdigest()[:24]
        return os.path.join(self.checkpoint_dir, f"leaf_{key}.json")

    def _load_ckpt(self, path: Optional[str]) -> Optional[Tuple[object, List[int]]]:
        if not path or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                d = json.load(f)
            proof = serde.system_proof_from_json(d["proof"])
            publics = [int(v) for v in d["publics"]]
            # never trust disk blindly: re-verify before reuse
            if not self.template.verify(proof, publics, self.cfg, device=self.device):
                log.warning("checkpoint %s failed verification; discarding", path)
                return None
            return proof, publics
        except Exception as e:
            log.warning("checkpoint %s unreadable (%s); discarding", path, e)
            return None

    def _save_ckpt(self, path: Optional[str], proof, publics: List[int]):
        if not path:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"proof": serde.system_proof_to_json(proof),
                       "publics": list(map(int, publics))}, f)
        os.replace(tmp, path)

    def _announce_prefetch(self, start_block: int, end_block: int,
                           global_end_header: bytes) -> None:
        """Announce every map job's fetch (the map circuit's clamp), except
        those of jobs with a checkpoint, which are not proved again."""
        for j in range(self.nb_map_jobs):
            bs_start = start_block + j * self.batch_size
            path = self._ckpt_path(bs_start, end_block, global_end_header)
            if path and os.path.exists(path):
                continue
            bs_end = max(bs_start, min(bs_start + self.batch_size, end_block))
            self.fetcher.prefetch(bs_start, bs_end, self.batch_size)

    # -- proving ------------------------------------------------------------

    def _prove_job(self, job: int, start_block: int, global_end: int,
                   global_end_header: bytes) -> LeafProof:
        batch_start = start_block + job * self.batch_size
        path = self._ckpt_path(batch_start, global_end, global_end_header)
        cached = self._load_ckpt(path)
        if cached is not None:
            log.info("map job %d: resumed from checkpoint", job)
            proof, publics = cached
        else:
            proof, publics = self.template.prove(
                batch_start, global_end, global_end_header, self.cfg, device=self.device)
            self._save_ckpt(path, proof, publics)
        return LeafProof(job, batch_start, list(publics), proof)

    def _prove_leaves(self, start_block: int, end_block: int,
                      global_end_header: Optional[bytes]):
        assert end_block - start_block <= self.batch_size * self.nb_map_jobs
        if global_end_header is None:
            global_end_header = self.fetcher.get_header(end_block).hash()
        self._announce_prefetch(start_block, end_block, global_end_header)
        try:
            leaves = [self._prove_job(j, start_block, end_block, global_end_header)
                      for j in range(self.nb_map_jobs)]
        finally:
            self.fetcher.release()
        return global_end_header, leaves

    def prove(self, start_block: int, end_block: int,
              global_end_header: Optional[bytes] = None) -> MapReduceProof:
        global_end_header, leaves = self._prove_leaves(
            start_block, end_block, global_end_header)
        final = _reduce_tree([
            _leaf_to_subchain(lf, self.batch_size, end_block) for lf in leaves
        ])
        if final.end_block != end_block or final.end_header != global_end_header:
            raise ValueError("reduce tree does not reach the global end")
        return MapReduceProof(
            start_block=start_block, end_block=end_block,
            batch_size=self.batch_size,
            global_end_header=global_end_header,
            leaves=leaves, data_commitment=final.data_merkle_root,
        )

    # -- verification -------------------------------------------------------

    def verify(self, agg: MapReduceProof, start_header: Optional[bytes] = None) -> bool:
        """Re-verify every leaf proof, re-derive the reduce tree, and check
        the claimed statement (incl. public-input binding per leaf)."""
        if len(agg.leaves) != self.nb_map_jobs:
            return False
        subchains = []
        for j, leaf in enumerate(agg.leaves):
            pb = bytes(leaf.publics)
            want_start = agg.start_block + j * self.batch_size
            bound = (want_start.to_bytes(8, "big")
                     + agg.end_block.to_bytes(8, "big")
                     + agg.global_end_header)
            if pb[:IN_BYTES] != bound:
                return False
            if not self.template.verify(leaf.proof, leaf.publics, self.cfg,
                                        device=self.device):
                return False
            subchains.append(_leaf_to_subchain(leaf, self.batch_size, agg.end_block))
        try:
            final = _reduce_tree(subchains)
        except ValueError:
            return False
        if start_header is not None and final.start_header != start_header:
            return False
        return (final.start_block == agg.start_block
                and final.end_block == agg.end_block
                and final.end_header == agg.global_end_header
                and final.data_merkle_root == agg.data_commitment)

    # -- succinct aggregation ----------------------------------------------

    def prove_succinct(self, start_block: int, end_block: int,
                       global_end_header: Optional[bytes] = None,
                       timer=None) -> SuccinctProof:
        """Prove all leaves, then walk the reduce tree with in-circuit
        verification of child proofs: the result is one proof. ``timer`` (a
        system.PhaseTimer) gets "map_jobs" for the leaves and every phase of
        the reduce proves."""
        assert self.succinct, "construct MapReduceProver(succinct=True)"
        dev = devmod.resolve(self.device)
        if timer is not None:
            timer.mark("map_jobs", dev)
        global_end_header, leaves = self._prove_leaves(
            start_block, end_block, global_end_header)
        level: List[Tuple[object, List[int]]] = [(lf.proof, lf.publics) for lf in leaves]
        span = self.batch_size * 2
        for rc in self.reduce_templates():
            nxt = []
            for i in range(0, len(level), 2):
                node_start = start_block + (i // 2) * span
                proof, publics = rc.prove(
                    node_start, end_block, global_end_header,
                    level[i], level[i + 1], self.cfg, device=dev, timer=timer)
                nxt.append((proof, list(publics)))
            level = nxt
            span *= 2
        if timer is not None:
            timer.end()
        assert len(level) == 1
        root_proof, root_publics = level[0]
        pb = bytes(root_publics)
        if pb[OUT_END_HEADER] != global_end_header:
            raise ValueError("root subchain does not reach the global end")
        return SuccinctProof(
            start_block=start_block, end_block=end_block,
            batch_size=self.batch_size, nb_map_jobs=self.nb_map_jobs,
            global_end_header=global_end_header,
            data_commitment=pb[OUT_DATA_ROOT],
            root_proof=root_proof, root_publics=list(root_publics),
        )

    def verify_succinct(self, agg: SuccinctProof,
                        start_header: Optional[bytes] = None) -> bool:
        """Verify exactly one proof, the root of the reduce tree, and bind
        its public bytes to the claimed statement."""
        if agg.nb_map_jobs != self.nb_map_jobs or not self.reduce_templates():
            return False
        root = self.reduce_templates()[-1]
        pb = bytes(agg.root_publics)
        bound = (agg.start_block.to_bytes(8, "big")
                 + agg.end_block.to_bytes(8, "big")
                 + agg.global_end_header)
        if pb[:IN_BYTES] != bound:
            return False
        if pb[OUT_END_HEADER] != agg.global_end_header:
            return False
        if pb[OUT_DATA_ROOT] != agg.data_commitment:
            return False
        if start_header is not None and pb[OUT_START_HEADER] != start_header:
            return False
        return root.verify(agg.root_proof, agg.root_publics, self.cfg, device=self.device)


# -- artifact serde -----------------------------------------------------------

def mapreduce_proof_to_json(agg: MapReduceProof) -> dict:
    return {
        "start_block": agg.start_block,
        "end_block": agg.end_block,
        "batch_size": agg.batch_size,
        "global_end_header": agg.global_end_header.hex(),
        "data_commitment": agg.data_commitment.hex(),
        "leaves": [
            {"job": lf.job, "batch_start": lf.batch_start,
             "publics": list(map(int, lf.publics)),
             "proof": serde.system_proof_to_json(lf.proof)}
            for lf in agg.leaves
        ],
    }


def mapreduce_proof_from_json(d: dict) -> MapReduceProof:
    return MapReduceProof(
        start_block=d["start_block"], end_block=d["end_block"],
        batch_size=d["batch_size"],
        global_end_header=bytes.fromhex(d["global_end_header"]),
        data_commitment=bytes.fromhex(d["data_commitment"]),
        leaves=[LeafProof(x["job"], x["batch_start"],
                          [int(v) for v in x["publics"]],
                          serde.system_proof_from_json(x["proof"]))
                for x in d["leaves"]],
    )
