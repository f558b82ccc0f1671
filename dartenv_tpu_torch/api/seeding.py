"""Seeding: behavioral reconstruction of the reference's seeding module
(`gym/utils/seeding.py:~1-100` † — SURVEY.md §2.1 "this exact algorithm
matters for seed-for-seed repro").

The algorithm (from the public spec): `create_seed` draws/derives a bigint
seed, `hash_seed` pushes it through SHA-512 and truncates, and `np_random`
seeds a NumPy RandomState with the 32-bit limbs of that hash.  Reset-noise
parity with the reference therefore only needs the same seed to reach the
same RandomState stream (SURVEY.md §3.3).  The batched path draws from a
`torch.Generator` instead; this module is the single-env gym path.
"""
from __future__ import annotations

import hashlib
import os
import struct
from typing import Optional, Tuple

import numpy as np

from dartenv_tpu_torch.api import error


def np_random(seed: Optional[int] = None) -> Tuple[np.random.RandomState, int]:
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise error.Error(
            "Seed must be a non-negative integer or omitted, not {}".format(
                seed
            )
        )
    seed = create_seed(seed)
    rng = np.random.RandomState()
    rng.seed(_int_list_from_bigint(hash_seed(seed)))
    return rng, seed


def hash_seed(seed: Optional[int] = None, max_bytes: int = 8) -> int:
    """Avoid correlated low-entropy seeds (e.g. worker ids 0..N) by hashing
    through SHA-512 before truncation."""
    if seed is None:
        seed = create_seed(max_bytes=max_bytes)
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()
    return _bigint_from_bytes(digest[:max_bytes])


def create_seed(a=None, max_bytes: int = 8) -> int:
    if a is None:
        a = _bigint_from_bytes(os.urandom(max_bytes))
    elif isinstance(a, str):
        a = a.encode("utf8")
        a += hashlib.sha512(a).digest()
        a = _bigint_from_bytes(a[:max_bytes])
    elif isinstance(a, int):
        a = a % 2 ** (8 * max_bytes)
    else:
        raise error.Error("Invalid type for seed: {} ({})".format(type(a), a))
    return a


def _bigint_from_bytes(b: bytes) -> int:
    sizeof_int = 4
    padding = sizeof_int - len(b) % sizeof_int
    b += b"\0" * padding
    int_count = len(b) // sizeof_int
    unpacked = struct.unpack("{}I".format(int_count), b)
    accum = 0
    for i, val in enumerate(unpacked):
        accum += 2 ** (sizeof_int * 8 * i) * val
    return accum


def _int_list_from_bigint(bigint: int):
    if bigint < 0:
        raise error.Error("Seed must be non-negative, not {}".format(bigint))
    elif bigint == 0:
        return [0]
    ints = []
    while bigint > 0:
        bigint, mod = divmod(bigint, 2 ** 32)
        ints.append(mod)
    return ints
