"""The prover's witness words (groth16/prover.py _wire_words, the native
pass of csrc/wirelimbs.cpp) and their widening (wire_widen's plain
version, which the CPU takes) against fields/tfield.py ints_to_limbs, their
plain reference: equal limbs, the count of wires that took the wide
branch, and the same errors."""

import numpy as np
import pytest
import torch

from blockmaze_tpu_torch.circuits import witnesses
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16.prover import _wire_words, wire_widen


class Sub(int):
    """An int subclass: not an exact int, so it takes the wide branch."""


def mint_witness():
    pb = witnesses.witness_mint()
    return pb.primary_input(), pb.auxiliary_input()


EDGES = [0, 1, True, False, 2**16 - 1, 2**16, 2**63, 2**64 - 1, 2**64,
         R_MOD - 1, 2**256 - 1, np.int64(2**40 + 3), Sub(2**20 + 5), -1,
         2**256]

CASES = ([pytest.param(lambda x=x: ([7], [x, 2**70, x]), id=repr(x))
          for x in EDGES]
         + [pytest.param(lambda: ((), []), id="empty"),
            pytest.param(lambda: ((3, 2**64 + 1), [True, 0]), id="tuple"),
            pytest.param(mint_witness, id="witness_mint")])


def is_wide(x) -> bool:
    """A wire the native pass leaves to Python."""
    return type(x) not in (int, bool) or not 0 <= x < 2**64


def widened(words, wide) -> np.ndarray:
    """wire_widen (its plain version: CPU tensors) as uint32 limbs."""
    return wire_widen(torch.from_numpy(words),
                      torch.from_numpy(wide)).numpy().view(np.uint32)


@pytest.mark.parametrize("make", CASES)
def test_wire_limbs_equal_ints_to_limbs(make):
    primary, aux = make()
    wires = [1] + list(primary) + list(aux)
    out = np.full(len(wires), 0xDEAD, np.int64)   # stale words
    try:
        want = tf.ints_to_limbs(wires)
    except OverflowError as e:
        with pytest.raises(OverflowError) as got:
            _wire_words(primary, aux, out)
        assert str(got.value) == str(e)
        return
    for buf in (out, np.empty_like(out)):     # reused, fresh
        words, wide = _wire_words(primary, aux, buf)
        assert words is buf and np.array_equal(widened(words, wide), want)
        assert len(wide) == sum(map(is_wide, wires))
        assert not words[wide[:, 0]].any()
    if len(wires) > 1000:       # the mint witness: a few field-width wires
        assert len(wide) == sum(x >= 2**64 for x in wires) and \
            0 < len(wide) < 10


def test_wire_limbs_reject_a_buffer_of_another_shape():
    with pytest.raises(ValueError, match="int64"):
        _wire_words([1], [2], np.empty(2, np.int64))
    with pytest.raises(ValueError, match="int64"):
        _wire_words([1], [2], np.empty(3, np.int32))
    with pytest.raises(ValueError, match="int64"):
        _wire_words([1], [2], np.empty((3, tf.N), np.uint32))


def split(values):
    """values as wire_widen's inputs, made here without the native pass:
    a word for each value below 2^64 (0 for the others), and a wide row
    (its index, its 16 limbs) for each of the others."""
    words = np.array([v if v < 2**64 else 0 for v in values],
                     np.uint64).view(np.int64)
    wide = np.array([[i, *tf.ints_to_limbs([v])[0]]
                     for i, v in enumerate(values) if v >= 2**64],
                    np.int64).astype(np.int32).reshape(-1, 1 + tf.N)
    return words, wide


@pytest.mark.parametrize("values", [
    pytest.param([], id="zero_rows"),
    pytest.param([2**64 + i for i in range(5)] + [R_MOD - 1, 2**256 - 1],
                 id="all_wide"),
    pytest.param([2**200 + 3, 0, 5, 2**64 - 1], id="wide_row_first"),
    pytest.param([7, 2**32, 2**63 + 1, R_MOD - 1], id="wide_row_last"),
    pytest.param([2**64 - 1, 2**64, 2**64 - 1, 2**64], id="2^64-1_by_2^64"),
])
def test_wire_widen_plain_equals_ints_to_limbs(values):
    words, wide = split(values)
    want = tf.ints_to_limbs(values).reshape(-1, tf.N)
    assert np.array_equal(widened(words, wide), want)
