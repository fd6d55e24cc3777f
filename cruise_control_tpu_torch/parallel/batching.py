"""Shape-bucket arithmetic and the flat model's host-side re-pad.

Port of ``cruise_control_tpu/parallel/batching.py``. The what-if engine pads
its scenario axis to a bucket multiple and re-pads the flat model when a
scenario batch outgrows the live model's padding slack; the move scheduler
buckets its move and batch axes to powers of two. The reference's
``ProgramCache`` is not ported: eager PyTorch compiles nothing, so there is
no program to cache per shape.
"""

from __future__ import annotations

import numpy as np


def round_up(n: int, multiple: int) -> int:
    """Next multiple of ``multiple`` at or above ``n`` (minimum one
    bucket: a zero/negative count still gives a real batch)."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def pow2_bucket(n: int) -> int:
    """Next power of two at or above ``n`` (minimum 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def pad_model_to(model, new_B: int, new_P: int, new_R: int):
    """Host-side re-pad of a ``FlatClusterModel`` to larger padded shapes
    (``new_B`` brokers x ``new_P`` partitions x ``new_R`` replica slots),
    rebuilt on the model's own device.

    New broker rows arrive invalid (masked out of every reduction), new
    partition rows empty (replica slots on the sentinel), so the padded
    model scores bit-identically to the original. A no-op when the shapes
    already match.
    """
    from ..model.flat import FlatClusterModel
    B = model.num_brokers_padded
    P, R = model.replica_broker.shape
    if (new_B, new_P, new_R) == (B, P, R):
        return model
    if new_B < B or new_P < P or new_R < R:
        raise ValueError(
            f"pad_model_to cannot shrink: have ({B}, {P}, {R}), "
            f"asked for ({new_B}, {new_P}, {new_R})")

    a = model.to_numpy()
    rb = a["replica_broker"]
    out_rb = np.full((new_P, new_R), new_B, np.int32)
    # The empty-slot sentinel is the one-past-last broker row, so it moves
    # with the broker padding: every old-sentinel entry must be rewritten.
    out_rb[:P, :R] = np.where(rb == B, new_B, rb)

    def pad_p(arr, fill):
        out = np.full((new_P,) + arr.shape[1:], fill, arr.dtype)
        out[:P] = arr
        return out

    def pad_b(arr, fill):
        out = np.full((new_B,) + arr.shape[1:], fill, arr.dtype)
        out[:B] = arr
        return out

    pref = np.tile(np.arange(new_R, dtype=np.int32), (new_P, 1))
    pref[:P, :R] = a["replica_pref_pos"]
    offline = np.zeros((new_P, new_R), bool)
    offline[:P, :R] = a["replica_offline"]
    return FlatClusterModel.from_numpy(
        device=model.device,
        replica_broker=out_rb,
        leader_load=pad_p(a["leader_load"], 0.0),
        follower_load=pad_p(a["follower_load"], 0.0),
        partition_topic=pad_p(a["partition_topic"], -1),
        partition_valid=pad_p(a["partition_valid"], False),
        replica_offline=offline,
        replica_pref_pos=pref,
        broker_capacity=pad_b(a["broker_capacity"], 0.0),
        broker_rack=pad_b(a["broker_rack"], 0),
        broker_host=pad_b(a["broker_host"], 0),
        broker_set=pad_b(a["broker_set"], -1),
        broker_alive=pad_b(a["broker_alive"], False),
        broker_new=pad_b(a["broker_new"], False),
        broker_demoted=pad_b(a["broker_demoted"], False),
        broker_broken_disk=pad_b(a["broker_broken_disk"], False),
        broker_valid=pad_b(a["broker_valid"], False))
