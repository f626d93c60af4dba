"""Pairwise-masked secure aggregation over fixed-point wires.

A copy of ``repro/privacy/secagg.py`` (numpy only): the blake2b pair seeds
and numpy's generator give masks bit-identical to the reference's, so a
wire masked by one package unmasks in the other.

The broker paths (sequential / pairwise / tree merges, the async ledger)
all reduce ADDITIVE exchange states.  Secure aggregation exploits that:
each site blinds its contribution with pairwise masks that cancel
exactly in the sum, so the broker only ever observes the aggregate —
never an individual site's statistics (Bonawitz et al. 2017, the
honest-but-curious variant; see docs/privacy.md for the threat model).

Why fixed-point wires
---------------------
Float addition is not associative, so float masks would leave
order-dependent residue and "cancel" only approximately.  We instead
encode every leaf as int64 fixed-point (``q = round(x * 2^frac_bits)``)
reinterpreted as uint64, and do ALL aggregation arithmetic mod 2^64.
Modular addition is associative and commutative, so

* mask cancellation is EXACT (bit-for-bit), and
* every merge order — sequential, pairwise, the mesh butterfly — yields
  the IDENTICAL aggregate wire.  `tests/test_privacy.py` pins both
  (`tests/test_torch_privacy.py` against this copy).

Masks
-----
For an ordered site pair (i, j) the shared mask is derived by hashing
(secret, round salt, sorted pair) with blake2b into a seed for numpy's
Philox-backed `default_rng` — a keyed KDF, not ambient randomness (the
repo-wide RPR007 rule bans unseeded/stdlib RNG in this package).  Site
``min`` ADDS the mask, site ``max`` SUBTRACTS it (mod 2^64), so the pair
contributes zero to the sum.  A site that drops out AFTER others sent
their masked wires leaves its pairwise masks uncancelled; the surviving
sites reveal the pair seeds and `unmask_dropout` regenerates and removes
those masks — the standard seed-reveal recovery.
"""
from __future__ import annotations

import hashlib

import numpy as np

Wire = list  # a wire is a list of uint64 ndarrays, one per tree leaf


class SecAggError(RuntimeError):
    """A wire that cannot be encoded/aggregated — message names the fix."""


# ---------------------------------------------------------------------------
# Fixed-point codec
# ---------------------------------------------------------------------------

def encode(leaves, frac_bits: int) -> Wire:
    """Encode float leaves (any array-likes) into uint64 fixed point.

    Values must satisfy ``|x| < 2^(62 - frac_bits)`` — the two spare bits
    leave headroom so a true aggregate over many sites still fits the
    signed range on decode (uint64 wrap-around is the masking mechanism,
    not a value overflow).
    """
    limit = float(2 ** (62 - frac_bits))
    scale = float(2**frac_bits)
    out = []
    for leaf in leaves:
        a = np.asarray(leaf, dtype=np.float64)
        if not np.all(np.isfinite(a)):
            raise SecAggError("cannot encode non-finite values into a "
                              "secagg wire — check the exchange state")
        if np.any(np.abs(a) >= limit):
            raise SecAggError(
                f"value magnitude >= 2^(62-frac_bits)={limit:g} cannot be "
                "fixed-point encoded — lower PrivacySpec.frac_bits or "
                "rescale the statistics"
            )
        q = np.round(a * scale).astype(np.int64)
        out.append(q.view(np.uint64))
    return out


def decode(wire: Wire, frac_bits: int, dtypes=None) -> list[np.ndarray]:
    """Invert `encode`: uint64 wire -> float leaves (float32 by default)."""
    scale = float(2**frac_bits)
    dtypes = dtypes or [np.float32] * len(wire)
    return [
        (np.asarray(leaf, dtype=np.uint64).view(np.int64) / scale).astype(dt)
        for leaf, dt in zip(wire, dtypes, strict=True)
    ]


def add_wires(a: Wire, b: Wire) -> Wire:
    """Leafwise sum mod 2^64 — the ONLY aggregation primitive."""
    return [
        (np.asarray(la, np.uint64) + np.asarray(lb, np.uint64))
        for la, lb in zip(a, b, strict=True)
    ]


def _neg(wire: Wire) -> Wire:
    return [np.uint64(0) - np.asarray(leaf, np.uint64) for leaf in wire]


# ---------------------------------------------------------------------------
# Pairwise masks
# ---------------------------------------------------------------------------

def _pair_rng(secret: str, round_salt, i, j) -> np.random.Generator:
    lo, hi = sorted((str(i), str(j)))
    material = f"{secret}|{round_salt}|{lo}|{hi}".encode()
    digest = hashlib.blake2b(material, digest_size=16).digest()
    return np.random.default_rng(int.from_bytes(digest, "big"))


def pair_mask(secret: str, round_salt, i, j, template: Wire) -> Wire:
    """The shared uint64 mask of the UNORDERED pair {i, j} (both sites
    derive the identical arrays from the shared secret)."""
    rng = _pair_rng(secret, round_salt, i, j)
    return [
        rng.integers(0, 2**64, size=np.asarray(leaf).shape, dtype=np.uint64)
        for leaf in template
    ]


def mask_wire(wire: Wire, site, participants, secret: str, round_salt) -> Wire:
    """Blind one site's wire with its pairwise masks for this round.

    The lexicographically smaller site of each pair adds the mask, the
    larger subtracts it, so summing ALL participants' masked wires gives
    exactly the unmasked sum.  An individual masked wire is uniformly
    distributed (one-time pad mod 2^64) as long as at least one pair
    partner is honest.
    """
    others = [p for p in participants if p != site]
    if len(others) == len(participants):
        raise SecAggError(f"site {site!r} is not among the participants")
    out = [np.asarray(leaf, np.uint64).copy() for leaf in wire]
    for other in others:
        m = pair_mask(secret, round_salt, site, other, wire)
        sign = 1 if str(site) < str(other) else -1
        for k, leaf in enumerate(m):
            out[k] = out[k] + leaf if sign > 0 else out[k] - leaf
    return out


def unmask_dropout(agg: Wire, dropped, submitted, secret: str,
                   round_salt) -> Wire:
    """Remove the uncancelled masks a dropped site left in the aggregate.

    ``agg`` is the sum of the SUBMITTED sites' masked wires; each dropped
    site d never contributed, so every submitted site s still carries its
    half of mask{s, d}.  Regenerate those masks from the revealed pair
    seeds and subtract them (seed-reveal recovery).
    """
    out = [np.asarray(leaf, np.uint64).copy() for leaf in agg]
    for d in dropped:
        for s in submitted:
            m = pair_mask(secret, round_salt, s, d, agg)
            sign = 1 if str(s) < str(d) else -1
            for k, leaf in enumerate(m):
                out[k] = out[k] - leaf if sign > 0 else out[k] + leaf
    return out


# ---------------------------------------------------------------------------
# Aggregation orders (all bit-identical — pinned by tests)
# ---------------------------------------------------------------------------

def aggregate(wires: list[Wire], strategy: str = "sequential") -> Wire:
    """Reduce wires under a merge strategy's reduction ORDER.

    Because the wire arithmetic is mod 2^64, every strategy returns the
    bit-identical aggregate; the strategies exist so the parity tests can
    pin that claim against each engine merge path (sequential left fold,
    pairwise host tree, the mesh butterfly's interleaved pairing).
    """
    if not wires:
        raise SecAggError("cannot aggregate zero wires")
    if strategy == "sequential":
        acc = wires[0]
        for w in wires[1:]:
            acc = add_wires(acc, w)
        return acc
    if strategy == "pairwise":
        level = list(wires)
        while len(level) > 1:
            nxt = [
                add_wires(level[k], level[k + 1])
                if k + 1 < len(level) else level[k]
                for k in range(0, len(level), 2)
            ]
            level = nxt
        return level[0]
    if strategy == "tree":
        # the butterfly pairing: distance-doubling partner exchange over a
        # zero-padded power-of-two slot array (fleet_sharded.merge_state_tree)
        n = len(wires)
        size = 1
        while size < n:
            size *= 2
        zeros = [np.zeros_like(np.asarray(leaf, np.uint64))
                 for leaf in wires[0]]
        slots = list(wires) + [zeros] * (size - n)
        dist = 1
        while dist < size:
            slots = [add_wires(slots[k], slots[k ^ dist])
                     for k in range(size)]
            dist *= 2
        return slots[0]
    raise SecAggError(f"unknown aggregation strategy {strategy!r}")
