"""Zcash-style append-only incremental Merkle tree (host side).

Mirrors src/deposit/IncrementalMerkleTree.{hpp,tcc}: nodes are combined with a
single PADDING-FREE SHA-256 compression of left||right with the standard IV
(SHA256Compress::combine -> CSHA256::FinalizeNoPadding,
IncrementalMerkleTree.tcc:14-24). Default depth 8 (VNT.h:6); depth 20 is the
production setting.
"""

from __future__ import annotations

import struct
from typing import List, Optional

DEPTH = 8  # INCREMENTAL_MERKLE_TREE_DEPTH (VNT.h:6)

_H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)
_M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def sha256_compress(block: bytes) -> bytes:
    """One SHA-256 compression of a 64-byte block with the standard IV and no
    padding (CSHA256::FinalizeNoPadding for a 64-byte write)."""
    assert len(block) == 64
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = _H0
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _K[i] + w[i]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32,
                                  c, b, a, (t1 + t2) & _M32)
    out = [(x + y) & _M32 for x, y in zip((a, b, c, d, e, f, g, h), _H0)]
    return struct.pack(">8I", *out)


def combine(a: bytes, b: bytes) -> bytes:
    """SHA256Compress::combine(a, b)."""
    return sha256_compress(a + b)


class MerklePath:
    """authentication_path[0] = layer below root; index[0] = top bit."""

    def __init__(self, authentication_path: List[bytes], index: List[bool]):
        self.authentication_path = authentication_path
        self.index = index

    @property
    def address(self) -> int:
        """convertVectorToInt(index): index[0] is the MSB."""
        v = 0
        for i, b in enumerate(self.index):
            if b:
                v |= 1 << (len(self.index) - 1 - i)
        return v


class _EmptyRoots:
    def __init__(self, depth):
        self.roots = [b"\x00" * 32]
        for _ in range(depth):
            self.roots.append(combine(self.roots[-1], self.roots[-1]))


class IncrementalMerkleTree:
    """IncrementalMerkleTree<Depth, SHA256Compress>."""

    def __init__(self, depth: int = DEPTH):
        self.depth = depth
        self.left: Optional[bytes] = None
        self.right: Optional[bytes] = None
        self.parents: List[Optional[bytes]] = []
        self._empty = _EmptyRoots(depth)

    def copy(self) -> "IncrementalMerkleTree":
        t = IncrementalMerkleTree(self.depth)
        t.left, t.right = self.left, self.right
        t.parents = list(self.parents)
        return t

    def append(self, obj: bytes):
        if self.is_complete(self.depth):
            raise RuntimeError("tree is full")
        if self.left is None:
            self.left = obj
        elif self.right is None:
            self.right = obj
        else:
            combined = combine(self.left, self.right)
            self.left = obj
            self.right = None
            for i in range(self.depth):
                if i < len(self.parents):
                    if self.parents[i] is not None:
                        combined = combine(self.parents[i], combined)
                        self.parents[i] = None
                    else:
                        self.parents[i] = combined
                        break
                else:
                    self.parents.append(combined)
                    break

    def is_complete(self, depth: int) -> bool:
        if self.left is None or self.right is None:
            return False
        if len(self.parents) != depth - 1:
            return False
        return all(p is not None for p in self.parents)

    def next_depth(self, skip: int) -> int:
        if self.left is None:
            if skip:
                skip -= 1
            else:
                return 0
        if self.right is None:
            if skip:
                skip -= 1
            else:
                return 0
        d = 1
        for parent in self.parents:
            if parent is None:
                if skip:
                    skip -= 1
                else:
                    return d
            d += 1
        return d + skip

    def _filler(self, filler_hashes):
        queue = list(filler_hashes)

        def next_at(depth):
            if queue:
                return queue.pop(0)
            return self._empty.roots[depth]

        return next_at

    def root(self, depth: Optional[int] = None, filler_hashes=()) -> bytes:
        depth = self.depth if depth is None else depth
        filler = self._filler(filler_hashes)
        cl = self.left if self.left is not None else filler(0)
        cr = self.right if self.right is not None else filler(0)
        root = combine(cl, cr)
        d = 1
        for parent in self.parents:
            if parent is not None:
                root = combine(parent, root)
            else:
                root = combine(root, filler(d))
            d += 1
        while d < depth:
            root = combine(root, filler(d))
            d += 1
        return root

    def path(self, filler_hashes=()) -> MerklePath:
        if self.left is None:
            raise RuntimeError("can't create a path for the empty tree")
        filler = self._filler(filler_hashes)
        path: List[bytes] = []
        index: List[bool] = []
        if self.right is not None:
            index.append(True)
            path.append(self.left)
        else:
            index.append(False)
            path.append(filler(0))
        d = 1
        for parent in self.parents:
            if parent is not None:
                index.append(True)
                path.append(parent)
            else:
                index.append(False)
                path.append(filler(d))
            d += 1
        while d < self.depth:
            index.append(False)
            path.append(filler(d))
            d += 1
        return MerklePath(list(reversed(path)), list(reversed(index)))

    def witness(self) -> "IncrementalWitness":
        return IncrementalWitness(self)

    @staticmethod
    def empty_root(depth: int = DEPTH) -> bytes:
        return _EmptyRoots(depth).roots[depth]


class IncrementalWitness:
    """Snapshot witness that tracks later appends (IncrementalMerkleTree.hpp:82)."""

    def __init__(self, tree: IncrementalMerkleTree):
        self.tree = tree.copy()
        self.filled: List[bytes] = []
        self.cursor: Optional[IncrementalMerkleTree] = None
        self.cursor_depth = 0

    def partial_path(self) -> List[bytes]:
        uncles = list(self.filled)
        if self.cursor is not None:
            uncles.append(self.cursor.root(self.cursor_depth))
        return uncles

    def append(self, obj: bytes):
        if self.cursor is not None:
            self.cursor.append(obj)
            if self.cursor.is_complete(self.cursor_depth):
                self.filled.append(self.cursor.root(self.cursor_depth))
                self.cursor = None
        else:
            self.cursor_depth = self.tree.next_depth(len(self.filled))
            if self.cursor_depth >= self.tree.depth:
                raise RuntimeError("tree is full")
            if self.cursor_depth == 0:
                self.filled.append(obj)
            else:
                self.cursor = IncrementalMerkleTree(self.tree.depth)
                self.cursor.append(obj)

    def path(self) -> MerklePath:
        return self.tree.path(self.partial_path())

    def root(self) -> bytes:
        return self.tree.root(self.tree.depth, self.partial_path())
