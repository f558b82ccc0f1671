"""The gym surface's seeding, as gym 0.9's `seeding.np_random` defines it:
a whole-number seed taken modulo 2**64, hashed by SHA-512, its first 8
bytes as 32-bit limbs seeding a numpy RandomState.  The benchmark's own
copy, so that it knows the reset noise a seeded env draws: each reset
draws uniform(-s, s) for q, then for dq."""
import hashlib
import struct

import numpy as np


def _bigint_from_bytes(b):
    b += b"\0" * (4 - len(b) % 4)
    vals = struct.unpack("{}I".format(len(b) // 4), b)
    return sum(2 ** (32 * i) * v for i, v in enumerate(vals))


def np_random(seed):
    seed = int(seed) % 2 ** 64
    big = _bigint_from_bytes(
        hashlib.sha512(str(seed).encode("utf8")).digest()[:8])
    ints = []
    while big > 0:
        big, mod = divmod(big, 2 ** 32)
        ints.append(mod)
    rng = np.random.RandomState()
    rng.seed(ints or [0])
    return rng


def reset_noises(seed, n, s):
    """The (2, 1, n) noise of each reset of an env seeded with `seed`, in
    order."""
    rng = np_random(seed)
    while True:
        q = rng.uniform(low=-s, high=s, size=n)
        dq = rng.uniform(low=-s, high=s, size=n)
        yield np.stack([q, dq])[:, None, :]
