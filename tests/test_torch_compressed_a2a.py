"""The port's all-to-all of pooled embeddings (`…_torch/parallel/
compressed_a2a.py`), plain and compressed to 8 and 4 bits, forward and
backward, against the JAX package's `compressed_all_to_all` and
`jax.lax.all_to_all` inside `shard_map` on the CPU: at world 1 on a
one-rank gloo group in this process, at world 2 as two gloo processes (one
module fixture) against a 2-device mesh. The payloads are [t_max, B, D]
slot-major pooled blocks, split on the batch and concatenated on the slots
as the hybrid step does; D = 6 packs INT4 nibbles, D = 5 does not. Bound:
1e-6 absolute (the same integers, dequantized by the same scales; the
plain exchange bit for bit)."""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mega_helpers as H
from deep_quantized_recommendation_model_dqrm_tpu.parallel import make_mesh
from deep_quantized_recommendation_model_dqrm_tpu.parallel.compressed_a2a import (
    compressed_all_to_all as j_compressed,
)
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost

torch.set_num_threads(1)

ATOL = 1e-6
CASES = [(bits, d) for bits in (32, 8, 4) for d in (6, 5)]


def job(n, bits, d, seed):
    rng = np.random.RandomState(seed)
    t_max, B = 3, 8
    x = (rng.randn(n * t_max, B, d) * 0.3).astype(np.float32)
    g = rng.randn(n * n * t_max, B // n, d).astype(np.float32)
    return {"kind": "a2a", "n": n, "bits": bits, "x": x, "g": g}


def run_jax(j):
    """JAX's exchange of the global [n t_max, B, D] (device r holds rows r
    t_max.. of it) and the VJP of the global cotangent."""
    n, bits = j["n"], j["bits"]

    def body(x):
        if bits >= 32:
            return jax.lax.all_to_all(x, "mp", 1, 0, tiled=True)
        return j_compressed(x, "mp", bits, 1, 0)

    f = shard_map(body, mesh=make_mesh(n), in_specs=P("mp"), out_specs=P("mp"), check_vma=False)
    y, vjp = jax.vjp(f, j["x"])
    (gx,) = vjp(j["g"])
    return np.asarray(y), np.asarray(gx)


def check(j, got_by_rank):
    y, gx = run_jax(j)
    n = j["n"]
    for r, got in enumerate(got_by_rank):
        np.testing.assert_allclose(got["y"], np.split(y, n)[r], rtol=0, atol=ATOL, err_msg=f"rank {r} y")
        np.testing.assert_allclose(got["gx"], np.split(gx, n)[r], rtol=0, atol=ATOL, err_msg=f"rank {r} gx")
        if j["bits"] >= 32:
            np.testing.assert_array_equal(got["y"], np.split(y, n)[r])


@pytest.fixture
def world1():
    multihost.init_distributed(device="cpu", timeout_s=60)
    try:
        yield
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("bits,d", CASES)
def test_exchange_world1_matches_jax(world1, bits, d):
    j = job(1, bits, d, seed=bits + d)
    check(j, [H.run_a2a(j, 0)])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jobs = {f"{bits}_{d}": job(2, bits, d, seed=10 + bits + d) for bits, d in CASES}
    return jobs, H.run_world2(str(tmp_path_factory.mktemp("a2a2")), jobs)


@pytest.mark.parametrize("bits,d", CASES)
def test_exchange_world2_matches_jax(world2, bits, d):
    jobs, got = world2
    name = f"{bits}_{d}"
    check(jobs[name], [got[0][name], got[1][name]])


def test_compressed_exchange_refuses_the_packed_axis(world1):
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel.compressed_a2a import compressed_all_to_all

    with pytest.raises(ValueError, match="last axis"):
        compressed_all_to_all(torch.zeros(2, 4), None, 8, 1, 0)
