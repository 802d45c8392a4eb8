"""Bit-exact counterpart of ``jax.random`` for the draws the sparse engine makes.

Reference: ``jax/_src/prng.py`` and ``jax/_src/random.py`` as installed with
jax 0.9.0, under ``jax_threefry_partitionable=True`` and 64-bit mode off —
the configuration the JAX package runs in. The simulation's seeded
trajectory is its output, so every draw here must reproduce jax's bits:

- a key is a raw threefry key, ``uint32[2]``; ``PRNGKey``, :func:`split` and
  :func:`fold_in` derive keys on the host (pure Python integers — key
  derivation never depends on device data, so it costs no device sync);
- :func:`random_bits` hashes the flat element index of the requested shape
  (the partitionable counter layout: high word 0, low word the index) and
  XORs the two output words, so :func:`random_bits_at` / :func:`uniform_at`
  give the same bits at chosen indices without drawing the rest;
- :func:`uniform` keeps the top 23 bits as a float32 mantissa in [1, 2) and
  subtracts 1; :func:`randint` is jax's two-draw span algorithm; and
  :func:`permutation` is ``_shuffle``: ceil(3·ln(n)/ln(2³²−1)) rounds of a
  stable sort keyed by 32-bit random bits.

Device draws run on int64 tensors holding uint32 values (torch's uint32
coverage is thin and CUDA sorts want int64 keys); every add masks to 32
bits, so the arithmetic wraps exactly like uint32.

An ensemble (sim/ensemble.py) gives every universe its own key: a
:class:`KeyBatch` holds B keys as host words, :func:`split` and
:func:`fold_in` derive B children at once (still on the host), and every
draw returns a leading universe axis ``[B, *shape]`` from ONE threefry
sequence over all universes. A :class:`KeyTable` uploads every key a tick
has derived as one tensor, each with its key schedule (the third word and
the five per-round adds) precomputed, so a draw reads a view of it and
per-universe keys add no launch per draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32, 20 rounds (prng.py::_threefry2x32_lowering).

    ``k1``/``k2`` are Python ints; ``x0``/``x1`` are Python ints or int64
    tensors holding uint32 values. Returns the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _words(key) -> tuple[int, int]:
    if isinstance(key, KeyBatch):
        raise TypeError("a KeyBatch holds several keys; index .words[b] for one")
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: ``[seed >> 32, seed]``
    (the high word is 0 with 64-bit mode off)."""
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit int32 (jax x64 is off)")
    return np.array([0, seed & _M32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` → ``uint32[num, 2]`` (the fold-like
    split: key i is the hash of counter (0, i)). A :class:`KeyBatch` gives
    a tuple of ``num`` KeyBatches (memoised: splitting the same batch the
    same way again returns the same children)."""
    if isinstance(key, KeyBatch):
        return key.split(num)
    k1, k2 = _words(key)
    out = np.empty((num, 2), dtype=np.uint32)
    for i in range(num):
        out[i] = _threefry2x32(k1, k2, 0, i)
    return out


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of counter (0, data)."""
    if isinstance(key, KeyBatch):
        return key.fold_in(data)
    k1, k2 = _words(key)
    return np.array(_threefry2x32(k1, k2, 0, int(data) & _M32), dtype=np.uint32)


def random_bits(key, shape, device) -> torch.Tensor:
    """32-bit draws of ``shape`` as an int64 tensor of uint32 values
    (``[B, *shape]`` for a :class:`KeyBatch`)."""
    numel = math.prod(shape)
    if numel >= 1 << 32:
        raise ValueError("draws of 2**32 elements or more need a high counter word")
    if isinstance(key, KeyBatch):
        idx = torch.arange(numel, dtype=torch.int64, device=device)
        b1, b2 = _threefry_rows(key.schedule(device), torch.zeros_like(idx), idx)
        return (b1 ^ b2).reshape((key.size,) + tuple(shape))
    k1, k2 = _words(key)
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(idx), idx)
    return (b1 ^ b2).reshape(shape)


def random_bits_at(key, counters: torch.Tensor, universe: torch.Tensor | None = None):
    """The bits :func:`random_bits` gives at the flat element indices
    ``counters`` (int64, any shape) of a draw, without drawing the rest:
    with the partitionable layout an element's bits depend only on its
    index. A :class:`KeyBatch` takes ``universe``, the universe of each
    counter (broadcast against ``counters``)."""
    zeros = torch.zeros_like(counters)
    if isinstance(key, KeyBatch):
        if key.size == 1:
            k1, k2 = (int(w) for w in key.words[0])
            b1, b2 = _threefry2x32(k1, k2, zeros, counters)
        else:
            sched = key.schedule(counters.device)[universe.long().expand(counters.shape)]
            b1, b2 = _threefry_rows(sched.reshape(-1, _SCHEDULE_WORDS),
                                    zeros.reshape(-1, 1), counters.reshape(-1, 1))
            b1, b2 = b1.view(counters.shape), b2.view(counters.shape)
        return b1 ^ b2
    k1, k2 = _words(key)
    b1, b2 = _threefry2x32(k1, k2, zeros, counters)
    return b1 ^ b2


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def uniform(key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    return _unit_float(random_bits(key, shape, device))


def uniform_at(key, counters: torch.Tensor, universe: torch.Tensor | None = None):
    """:func:`uniform`'s values at the flat indices ``counters`` only
    (:func:`random_bits_at`)."""
    return _unit_float(random_bits_at(key, counters, universe))


def gumbel_order(key, shape, device) -> torch.Tensor:
    """The order of ``jax.random.gumbel(key, shape)`` as int64 tensors: the
    23 mantissa bits its uniform draw is made of.

    jax's default ("low") mode returns ``-log(-log(u))`` with
    ``u = max(tiny, m·2⁻²³)``. XLA-CPU's float32 map from ``m`` to that
    value is strictly increasing over all 2²³ values of ``m`` (checked
    exhaustively by ``tests/test_torch_prng.py``), so ranking by ``m``
    ranks exactly as the Gumbel values do, equal values included, with no
    float ``log`` whose last bit could differ between libraries."""
    return random_bits(key, shape, device) >> 9


def randint(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` with static
    bounds: two 32-bit draws reduced modulo the span in wrapping uint32."""
    kh, kl = split(key)
    hi = random_bits(kh, shape, device)
    lo = random_bits(kl, shape, device)
    span = maxval - minval if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + (lo % span)) & _M32
    return ((off % span) + minval).to(torch.int32)


def permutation(key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (random.py::_shuffle) as int32
    (``[B, n]`` for a :class:`KeyBatch`, each row sorted on its own)."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(key, KeyBatch):
        x = x.expand(key.size, n)
    for _ in range(_shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True).indices
        x = torch.gather(x, 1, order) if x.dim() == 2 else x[order]
    return x.to(torch.int32)


def _shuffle_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


#: Words of a key's schedule row: the three key words, then the five
#: per-round adds of the second counter word (``ks[(i+2) % 3] + i + 1``).
_SCHEDULE_WORDS = 8


def _threefry_rows(sched: torch.Tensor, x0, x1):
    """:func:`_threefry2x32` for B keys at once: ``sched`` is the ``[B, 8]``
    schedule (:data:`_SCHEDULE_WORDS`), ``x0``/``x1`` the counter words of
    one draw, broadcast against a leading universe axis."""
    w = sched.reshape(sched.shape[0], _SCHEDULE_WORDS, 1)
    x0 = (x0 + w[:, 0]) & _M32
    x1 = (x1 + w[:, 1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + w[:, (i + 1) % 3]) & _M32
        x1 = (x1 + w[:, 3 + i]) & _M32
    return x0, x1


class KeyBatch:
    """B raw threefry keys, one per universe (``words``: ``uint32[B, 2]``).

    Children from :meth:`split` / :meth:`fold_in` are derived on the host,
    memoised, and registered with the :class:`KeyTable` the batch belongs
    to, so the table can upload a whole tick's keys at once. A draw from a
    key the table has not uploaded uploads that key alone."""

    def __init__(self, words, table: "KeyTable | None" = None):
        self.words = np.asarray(words, dtype=np.uint32).reshape(-1, 2)
        self._table = table
        self._children: dict = {}
        self._sched: torch.Tensor | None = None
        if table is not None:
            table.keys.append(self)

    @property
    def size(self) -> int:
        return self.words.shape[0]

    def _hash(self, counters) -> np.ndarray:
        """``uint32[B, C, 2]``: every key hashing every counter (0, c)."""
        k = self.words.astype(np.int64)[:, None, :]
        h1, h2 = _threefry2x32(k[..., 0], k[..., 1], 0, np.asarray(counters, np.int64)[None, :])
        return np.stack([h1, h2], axis=-1).astype(np.uint32)

    def split(self, num: int = 2) -> tuple:
        got = self._children.get(("split", num))
        if got is None:
            words = self._hash(np.arange(num))
            got = tuple(KeyBatch(words[:, i], self._table) for i in range(num))
            self._children[("split", num)] = got
        return got

    def fold_in(self, data: int) -> "KeyBatch":
        got = self._children.get(("fold", int(data)))
        if got is None:
            got = KeyBatch(self._hash([int(data) & _M32])[:, 0], self._table)
            self._children[("fold", int(data))] = got
        return got

    def schedule(self, device) -> torch.Tensor:
        """The ``[B, 8]`` schedule on ``device`` (a view of the table's
        upload once :meth:`KeyTable.upload` ran)."""
        if self._sched is None:
            self._sched = torch.from_numpy(_schedule_rows(self.words)).to(device)
        return self._sched


def _schedule_rows(words: np.ndarray) -> np.ndarray:
    """``int64[..., 8]`` schedules of ``uint32[..., 2]`` keys: the key
    words and the per-round adds."""
    k1 = words[..., 0].astype(np.int64)
    k2 = words[..., 1].astype(np.int64)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    adds = [ks[(i + 2) % 3] + i + 1 for i in range(5)]
    return np.stack(list(ks) + adds, axis=-1)


class KeyTable:
    """Every key one ensemble tick derives, uploaded together.

    ``KeyTable(rng)`` wraps the stacked ``uint32[B, 2]`` state keys as
    :attr:`root`; the tick derives its keys from it on the host, then
    :meth:`upload` moves the schedules of all of them to the device in one
    transfer."""

    def __init__(self, rng):
        self.keys: list[KeyBatch] = []
        self.root = KeyBatch(rng, self)

    def upload(self, device) -> None:
        todo = [k for k in self.keys if k._sched is None]
        if not todo:
            return
        rows = torch.from_numpy(_schedule_rows(np.stack([k.words for k in todo])))  # [K, B, 8]
        if torch.device(device).type == "cuda":
            # Staged in pinned memory and copied without blocking the host:
            # a pageable copy would wait for every launch queued before it.
            table = rows.pin_memory().to(device, non_blocking=True)
        else:
            table = rows.to(device)
        for i, k in enumerate(todo):
            k._sched = table[i]
