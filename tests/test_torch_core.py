"""The port's prove core and driver entry (ministark_tpu_torch/stark/core.py,
ministark_tpu_torch/entry.py) on the CPU: make_prove_core against the JAX
package's make_prove_core at n = 256 for Fibonacci and MiMC over Goldilocks
and BabyBear, on the example arguments and on inputs from a numpy seed
(through convert.from_jax_packed / to_jax_packed, tolerance 0); entry()
with device="cpu"; and dryrun_multichip on two CPU gloo ranks, every rank
byte-equal to one device. The sharded core itself is held to the JAX core
in tests/test_torch_sharded_engine.py's groups."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ministark_tpu.fields import BabyBear as J_BB
from ministark_tpu.fields import Goldilocks as J_GL
from ministark_tpu.models.mimc import mimc_device_trace as j_mimc
from ministark_tpu.stark.core import make_prove_core as j_make_prove_core
from ministark_tpu_torch.convert import from_jax_packed, to_jax_packed
from ministark_tpu_torch.entry import ENTRY_N, dryrun_multichip, entry
from ministark_tpu_torch.fields import BabyBear, Goldilocks
from ministark_tpu_torch.models.mimc import mimc_device_trace
from ministark_tpu_torch.stark.core import make_prove_core

N = 256
FIELDS = {"gl": (Goldilocks, J_GL), "bb": (BabyBear, J_BB)}
MODELS = {"fibonacci": (None, None), "mimc": (mimc_device_trace, j_mimc)}
CASES = [(f, m) for f in FIELDS for m in MODELS]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_core(field, model):
    return j_make_prove_core(FIELDS[field][1], N, MODELS[model][1])


def _port_core(field, model):
    return make_prove_core(FIELDS[field][0], N, MODELS[model][0], device="cpu")


def _jax_outputs(field, model, cols, shift, weights):
    """The JAX core's outputs on the port's inputs, as port tensors."""
    base = FIELDS[field][0].base
    core, _ = _jax_core(field, model)
    out = core(*(jnp.asarray(to_jax_packed(t, base)) for t in (cols, shift, weights)))
    return [from_jax_packed(np.asarray(o), base) for o in out]


@pytest.mark.parametrize("field,model", CASES)
def test_example_args_match_jax(field, model):
    base = FIELDS[field][0].base
    _, j_args = _jax_core(field, model)
    _, args = _port_core(field, model)
    for got, want in zip(args(), j_args()):
        assert torch.equal(got, from_jax_packed(np.asarray(want), base).reshape(got.shape))


@pytest.mark.parametrize("field,model", CASES)
def test_core_matches_jax(field, model):
    core, args = _port_core(field, model)
    cols, shift, weights = args()
    out = core(cols, shift, weights)
    w, t = cols.shape[0], weights.shape[0] - cols.shape[0]
    assert [tuple(o.shape) for o in out] == [(w + t, 2 * N), (N,), (N // 2,)]
    for got, want in zip(out, _jax_outputs(field, model, cols, shift, weights)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("field,model", CASES)
def test_core_matches_jax_on_seeded_inputs(field, model):
    """Random columns, coset offset and weights (numpy seed) through both."""
    sf = FIELDS[field][0]
    p = sf.base.p
    core, args = _port_core(field, model)
    cols0, _, weights0 = args()
    rng = np.random.default_rng([14, len(field), len(model)])

    def rand(shape):
        v = rng.integers(1, p, size=shape, dtype=np.uint64)
        return torch.from_numpy(v.view(np.int64))

    cols, shift, weights = rand(cols0.shape), rand(()), rand(weights0.shape)
    out = core(cols, shift, weights)
    for got, want in zip(out, _jax_outputs(field, model, cols, shift, weights)):
        assert torch.equal(got, want)
    # an int coset offset is the same core
    assert all(torch.equal(a, b) for a, b in zip(core(cols, int(shift), weights), out))


def test_entry_on_the_cpu():
    core, args = entry(device="cpu")
    cols, shift, weights = args
    assert cols.device.type == "cpu" and tuple(cols.shape) == (3, ENTRY_N)
    out = core(*args)
    assert [tuple(o.shape) for o in out] == [(6, 2 * ENTRY_N), (ENTRY_N,), (ENTRY_N // 2,)]
    for got, want in zip(out, _jax_outputs("gl", "fibonacci", cols, shift, weights)):
        assert torch.equal(got, want)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    collectives = dryrun_multichip(2, device="cpu", backend="gloo")
    assert set(collectives) == {"parity", "mimc", "fast", "fast_fold8_arity8",
                                "stir", "whir"}
    assert all(c > 0 for c in collectives.values())
    lines = capsys.readouterr().out.splitlines()
    assert sum("dryrun_multichip(2)" in ln for ln in lines) == 9
