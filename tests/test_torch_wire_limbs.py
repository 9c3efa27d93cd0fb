"""The prover's witness limbs (groth16/prover.py _wire_limbs, the native
pass of csrc/wirelimbs.cpp) against fields/tfield.py ints_to_limbs, its
plain reference: equal limbs, the count of wires that took the wide
branch, and the same errors."""

import numpy as np
import pytest

from blockmaze_tpu_torch.circuits import witnesses
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16.prover import _wire_limbs


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


@pytest.mark.parametrize("make", CASES)
def test_wire_limbs_equal_ints_to_limbs(make):
    primary, aux = make()
    wires = [1] + list(primary) + list(aux)
    out = np.full((len(wires), tf.N), 0xDEAD, np.uint32)   # stale rows
    try:
        want = tf.ints_to_limbs(wires)
    except OverflowError as e:
        with pytest.raises(OverflowError) as got:
            _wire_limbs(primary, aux, out)
        assert str(got.value) == str(e)
        return
    for buf in (out, np.empty_like(out)):     # reused, fresh
        limbs, wide = _wire_limbs(primary, aux, buf)
        assert limbs is buf and np.array_equal(limbs, want)
        assert wide == sum(map(is_wide, wires))
    if len(wires) > 1000:       # the mint witness: a few field-width wires
        assert wide == sum(x >= 2**64 for x in wires) and 0 < wide < 10


def test_wire_limbs_reject_a_buffer_of_another_shape():
    with pytest.raises(ValueError, match="uint32"):
        _wire_limbs([1], [2], np.empty((2, tf.N), np.uint32))
    with pytest.raises(ValueError, match="uint32"):
        _wire_limbs([1], [2], np.empty((3, tf.N), np.int32))
