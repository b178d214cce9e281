"""The port's parameter contract equals the JAX package's, field by field."""

import dataclasses

import pytest
import torch

import libmpc_tpu.types as jt
import libmpc_tpu_torch.types as tt
from libmpc_tpu.dims import LDims as JLDims, NLDims as JNLDims
from libmpc_tpu_torch.dims import LDims, NLDims


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["Parameters", "LParameters", "NLParameters",
                                  "HorizonSlice"])
def test_dataclass_fields_and_defaults_match(name):
    assert _fields(getattr(tt, name)) == _fields(getattr(jt, name))


@pytest.mark.parametrize("name", ["ResultStatus", "ConstraintsType"])
def test_enums_match(name):
    assert {e.name: int(e) for e in getattr(tt, name)} == {
        e.name: int(e) for e in getattr(jt, name)
    }


def test_result_and_sequence_fields_match():
    assert [f.name for f in dataclasses.fields(tt.Result)] == [
        f.name for f in dataclasses.fields(jt.Result)]
    assert [f.name for f in dataclasses.fields(tt.OptSequence)] == [
        f.name for f in dataclasses.fields(jt.OptSequence)]
    r = tt.zero_result(4, torch.float64, batch=(3,), device="cpu")
    assert r.cmd.shape == (3, 4) and r.status.dtype == torch.int32
    assert bool((r.status == int(tt.ResultStatus.UNKNOWN)).all())


def test_parameters_hashable_and_comparable():
    a, b = tt.LParameters(rho=0.01), tt.LParameters(rho=0.01)
    assert a == b and hash(a) == hash(b)
    assert dataclasses.replace(a, rho=0.1) != a


def test_horizon_slice_sentinel():
    assert tt.HorizonSlice.all().is_unset
    assert not tt.HorizonSlice(0, 3).is_unset


def test_default_dtype_setting():
    assert tt.default_dtype() == torch.float32
    tt.set_default_dtype(torch.float64)
    try:
        assert tt.default_dtype() == torch.float64
    finally:
        tt.set_default_dtype(torch.float32)
    with pytest.raises(ValueError):
        tt.set_default_dtype(torch.int32)


@pytest.mark.parametrize("dims", [(1, 1, 1, 1, 1, 1), (5, 3, 3, 7, 7, 5),
                                  (12, 4, 4, 12, 10, 10)])
def test_ldims_derived_sizes_match(dims):
    a, b = LDims(*dims), JLDims(*dims)
    for prop in ("nxu", "n_aug", "n_du", "nz", "n_eq", "n_box", "n_out",
                 "n_dub", "n_sc", "n_ineq", "m"):
        assert getattr(a, prop) == getattr(b, prop), prop
    assert NLDims(2, 1, 2, 5, 3, 6, 0).nz == JNLDims(2, 1, 2, 5, 3, 6, 0).nz


def test_quadrotor_qp_size():
    d = LDims(12, 4, 4, 12, 10, 10)
    assert (d.nz, d.m) == (216, 535)
