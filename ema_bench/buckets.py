"""The preproc bucket of every pair, worked out from the generator's
barcodes and whitelist alone, and the pairs that the program's bucket
files hold anywhere else.

The rule is EMA's ``preproc`` (correct.cc:389-412): the whitelist is read
into a ``std::unordered_map<uint32_t, ...>`` in file order; visited in
that map's iteration order, every whitelist barcode goes to the bucket
that holds the fewest pairs so far, ties to the lowest bucket
(``ema-bin-000`` first).  A barcode is its 16 bases in 2-bit codes
(A C G T = 0 1 2 3), the first base highest.

The map's iteration order is libstdc++'s: ``std::hash<uint32_t>`` is the
identity; a key entering an empty bucket goes to the front of the
map's one list, a key entering an occupied bucket to the front of that
bucket's run; a rehash takes the nodes in list order into the new
buckets by the same two rules.  ``_BUCKETS`` is the bucket count a map
steps through as it grows from empty under ``_Prime_rehash_policy``
(maximum load 1.0, growth factor 2: the first insert allocates 13, and
the insert that would pass the count takes the next entry of
``__prime_list`` at or above twice it).
"""

from __future__ import annotations

import heapq

import numpy as np

_BUCKETS = (13, 29, 59, 127, 257, 541, 1109, 2357, 5087, 10273, 20753,
            42043, 85229, 172933)


def barcode_key(bc: str) -> int:
    v = 0
    for c in bc:
        v = (v << 2) | "ACGT".index(c)
    return v


def map_order(keys: list) -> list:
    """Indices of the distinct ``keys``, inserted in this order, in the
    iteration order of a libstdc++ ``std::unordered_map``."""
    if len(keys) > _BUCKETS[-1]:
        raise ValueError(f"{len(keys)} keys: past the rehash schedule "
                         "that this rule carries")
    head = -1                  # the list's first node; -1: none
    nxt = [-1] * len(keys)
    # per bucket, the node before its run: -1 none, -2 the list's head
    before = [-1]
    step = -1

    def link(b):
        return head if b == -2 else nxt[b]

    for i, k in enumerate(keys):
        if i >= (_BUCKETS[step] if step >= 0 else 0):
            step += 1
            n = _BUCKETS[step]
            new = [-1] * n
            p, head, first_bkt = head, -1, 0
            while p != -1:
                q = nxt[p]
                b = keys[p] % n
                if new[b] == -1:
                    nxt[p] = head
                    head = p
                    new[b] = -2
                    if nxt[p] != -1:
                        new[first_bkt] = p
                    first_bkt = b
                else:
                    nxt[p] = link(new[b])
                    if new[b] == -2:
                        head = p
                    else:
                        nxt[new[b]] = p
                p = q
            before = new
        b = k % len(before)
        if before[b] != -1:
            nxt[i] = link(before[b])
            if before[b] == -2:
                head = i
            else:
                nxt[before[b]] = i
        else:
            nxt[i] = head
            head = i
            if nxt[i] != -1:
                before[keys[nxt[i]] % len(before)] = i
            before[b] = -2
    out = []
    p = head
    while p != -1:
        out.append(p)
        p = nxt[p]
    return out


def expected(whitelist: list, pair_bcs: list, n_buckets: int) -> np.ndarray:
    """The bucket (0 for ``ema-bin-000``) of each pair, from the whitelist
    in file order and each pair's barcode."""
    keys = [barcode_key(b) for b in whitelist]
    size = {}
    for b in pair_bcs:
        size[b] = size.get(b, 0) + 1
    heap = [(0, j) for j in range(n_buckets)]
    where = {}
    for i in map_order(keys):
        s, j = heapq.heappop(heap)
        where[whitelist[i]] = j
        heapq.heappush(heap, (s + size.get(whitelist[i], 0), j))
    return np.asarray([where[b] for b in pair_bcs], np.int64)


def misplaced(want: np.ndarray, names: list, files: list) -> int:
    """Lines of the bucket ``files`` (``ema-bin-000`` first) that are no
    pair's or lie outside their pair's ``want`` bucket, and pairs that
    their own bucket holds other than once."""
    at = {nm: k for k, nm in enumerate(names)}
    seen = np.zeros(len(names), np.int64)
    bad = 0
    for j, path in enumerate(files):
        with open(path) as f:
            for ln in f:
                k = at.get(ln.split(" ", 2)[1].lstrip("@"), -1)
                if k < 0 or want[k] != j:
                    bad += 1
                    continue
                seen[k] += 1
    return bad + int(np.abs(seen - 1).sum())
