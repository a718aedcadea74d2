"""Beyond-paper optimization flags (a copy of ``repro/launch/optflags.py``).

The paper-faithful baseline runs with NO flags. The layout flags act
through ``launch/shard_rules.py`` and ``models/sharding.py``:

  resident_weights  — drop FSDP ('data') sharding of weights so they stay
                      resident per device instead of being re-gathered at
                      every use.
  ep_all_axes       — MoE expert parallelism over ('model', 'data')
                      jointly: experts resident at 1/device, the
                      all_to_all spans both axes.
  flat_dp           — pure data parallelism: the batch shards over every
                      axis, weights FSDP-shard one dim over every axis, no
                      tensor parallelism.
  tp2d              — tensor-parallel dims shard over ('model', 'data').
  microbatches=N    — the train step's gradient-accumulation depth.
  chunked_prefill=N — the dry run's prefill step walks the prompt in
                      chunks of N tokens.
  donate            — recorded in the dry run's meta (the reference
                      donates the step's buffers; the port's steps update
                      theirs in place).
  causal_skip       — the no-cache forward's query-block loop skips the
                      blocks above the diagonal
                      (``models/attention.py::_gqa_causal_skip``), and the
                      roofline counts the reference's halved FLOPs.

Accepted and changing nothing in the port:

  pallas_paged_attn, pallas_chunk_prefill — the reference's routes of
                      paged attention through its Pallas kernels. The
                      port routes K3-K5 to its hand-written kernels
                      unconditionally.
"""
from __future__ import annotations

ACTIVE: set = set()


def set_flags(flags):
    ACTIVE.clear()
    ACTIVE.update(f for f in flags if f)


def has(flag: str) -> bool:
    return flag in ACTIVE


def get_int(prefix: str, default: int) -> int:
    for f in ACTIVE:
        if f.startswith(prefix + "="):
            return int(f.split("=", 1)[1])
    return default
