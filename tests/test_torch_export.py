"""The port's serving artifact (`serving.export_stablehlo` /
`load_stablehlo`, a `torch.export` program) against its own serving
function and against the JAX package's StableHLO artifact of the same
weights, the exported graph's kernel ops, and `torch.library.opcheck` of
the three registered ops (K2, K3, K4)."""

import jax
import numpy as np
import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu import serving as jserving
from deep_quantized_recommendation_model_dqrm_tpu.models import dlrm as jdlrm
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import serving as tserving
from deep_quantized_recommendation_model_dqrm_tpu_torch.data import synthetic as tsyn
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import onehot_update as toh
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import packed_embedding as tpe
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import quant_matmul as tqm
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import params_from_numpy

torch.set_num_threads(1)

SIZES = (300, 20, 150, 7, 1000)  # MD widths 3, 8, 3, 8, 2
B = 32
JAX_ATOL = 1e-6  # the bound of tests/test_torch_serving.py
# name: (config fields, emb_bits, mlp_bits, rowwise)
VARIANTS = {
    "int4_mlp8": ({}, 4, 8, False),
    "int8_mlp8": ({}, 8, 8, False),
    "int4_mlp32": ({}, 4, 32, False),
    "int8_rowwise_mlp32": ({}, 8, 32, True),
    "qr_mult": (dict(qr_flag=True, qr_threshold=100), 4, 8, False),
    "md": (dict(md_flag=True, md_threshold=100), 8, 8, False),
    "vw_fixed": (dict(weighted_pooling="fixed"), 4, 8, False),
    "vw_learned_qr": (dict(weighted_pooling="learned", qr_flag=True, qr_threshold=100), 4, 8, False),
    "cat": (dict(interaction="cat", mlp_top=(48, 8, 1)), 4, 8, False),
}


def models(name):
    """(JAX config, port config, JAX ServingModel, port ServingModel) of the
    same numpy weights (pooling weights drawn from U(0.5, 1.5))."""
    kw, emb_bits, mlp_bits, rowwise = VARIANTS[name]
    fields = dict(table_sizes=SIZES, embedding_dim=8, mlp_bot=(4, 16, 8), mlp_top=(23, 8, 1))
    fields.update(kw)
    jc, tc = jcfg.DLRMConfig(**fields), tcfg.DLRMConfig(**fields)
    jp = jdlrm.init_params(jc, seed=1)
    if jc.weighted_pooling:
        rng = np.random.RandomState(2)
        jp["v_W"] = [rng.uniform(0.5, 1.5, n).astype(np.float32) for n in SIZES]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return (jc, tc, jserving.ptq_export(jc, jp, emb_bits, mlp_bits, rowwise),
            tserving.ptq_export(tc, tp, emb_bits, mlp_bits, rowwise))


def batch(tc, seed=3):
    return tsyn.random_batch(tc, B, np.random.RandomState(seed), device="cpu")._replace(mask=None)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_artifact_is_bit_equal_to_the_serving_fn(name, tmp_path):
    """`export_stablehlo` -> `load_stablehlo` gives the serving function's
    probabilities bit for bit on two batches (the same plain versions in
    the same order)."""
    _, tc, _, tsm = models(name)
    path = tserving.export_stablehlo(tsm, B, str(tmp_path / "serving.pt2"))
    fn = tserving.load_stablehlo(path)
    eager = tserving.make_serving_fn(tsm)
    for seed in (3, 4):
        b = batch(tc, seed)
        got = fn(b.dense, b.indices)
        assert got.shape == (B,) and got.dtype == torch.float32
        assert torch.equal(got, eager(b))


@pytest.mark.parametrize("name", ["int4_mlp8", "int8_rowwise_mlp32", "qr_mult", "md", "vw_fixed", "cat"])
def test_artifact_matches_jax_artifact(name, tmp_path):
    """Each package's artifact of the same numpy weights, loaded by its own
    package, on the same batch: within 1e-6."""
    _, tc, jsm, tsm = models(name)
    jfn = jserving.load_stablehlo(jserving.export_stablehlo(jsm, B, str(tmp_path / "jax.bin")))
    tfn = tserving.load_stablehlo(tserving.export_stablehlo(tsm, B, str(tmp_path / "torch.pt2")))
    b = batch(tc)
    want = np.asarray(jfn(b.dense.numpy(), b.indices.numpy()))
    np.testing.assert_allclose(tfn(b.dense, b.indices).numpy(), want, rtol=0, atol=JAX_ATOL)


def kernel_ops(program):
    return [str(n.target) for n in program.graph.nodes if str(n.target).startswith("dqrm.")]


@pytest.mark.parametrize("name", ["int4_mlp8", "int4_mlp32", "qr_mult", "md"])
def test_exported_graph_holds_one_k2_and_k3_per_int8_layer(name):
    """The program calls K2 once for all packed tables (QR's q and r and
    MD's narrow tables included) and K3 once per int8 layer; the float32
    MLP takes no K3."""
    _, tc, _, tsm = models(name)
    ops = kernel_ops(tserving.export_program(tsm, B))
    layers = len(tc.mlp_bot) + len(tc.mlp_top) - 2
    assert ops.count("dqrm.packed_pooled_lookup_grouped.default") == 1
    assert ops.count("dqrm.int8_linear.default") == (layers if tsm.mlp_bits == 8 else 0)
    assert len(ops) == 1 + ops.count("dqrm.int8_linear.default")


def test_artifact_counts_no_launch_on_the_cpu(tmp_path):
    """On the CPU the program's ops take the plain versions: no kernel
    launch is counted."""
    _, tc, _, tsm = models("int4_mlp8")
    fn = tserving.load_stablehlo(tserving.export_stablehlo(tsm, B, str(tmp_path / "s.pt2")))
    before = (tpe.packed_pooled_lookup_grouped.launches, tqm.int8_linear.launches)
    b = batch(tc)
    fn(b.dense, b.indices)
    assert (tpe.packed_pooled_lookup_grouped.launches, tqm.int8_linear.launches) == before


def test_opcheck_int8_linear():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(9, 13).astype(np.float32))
    qw = tqm.quantize_linear_weights(torch.from_numpy(rng.randn(6, 13).astype(np.float32)),
                                     torch.from_numpy(rng.randn(6).astype(np.float32)))
    for relu in (False, True):
        args = (x, qw.w_int, qw.scale, qw.bias, relu)
        torch.library.opcheck(torch.ops.dqrm.int8_linear.default, args)
        assert torch.equal(torch.ops.dqrm.int8_linear(*args), tqm.int8_linear_xla(x, qw, relu))


@pytest.mark.parametrize("masked", [False, True])
def test_opcheck_packed_pooled_lookup_grouped(masked):
    """INT4 and INT8 symmetric and rowwise tables of mixed widths, one with
    a gap after its block: the op equals the plain grouped version, 0 in
    the gap."""
    rng = np.random.RandomState(6)
    tables = [tpe.pack_table(torch.from_numpy(rng.randn(n, d).astype(np.float32)), bits, rowwise)
              for n, d, bits, rowwise in ((50, 8, 4, False), (30, 8, 8, True), (20, 6, 8, False),
                                          (40, 4, 4, True))]
    slots, cols, width = [0, 1, 3, 2], [0, 8, 16, 24], 30
    idx = torch.from_numpy(rng.randint(-2, 52, size=(4, 5, 3)).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(0, 1, (4, 5, 3)).astype(np.float32)) if masked else None
    args = ([t.data for t in tables], [t.scale for t in tables], [t.bias for t in tables],
            [t.bits for t in tables], [t.dim for t in tables], slots, cols, width, idx, mask)
    torch.library.opcheck(torch.ops.dqrm.packed_pooled_lookup_grouped.default, args)
    got = torch.ops.dqrm.packed_pooled_lookup_grouped(*args)
    want = tpe.packed_pooled_lookup_grouped_plain(tpe.make_packed_group(tables, slots, cols, width), idx, mask)
    assert got.shape == (width * 5,) and torch.equal(got, want)
    assert not got.view(width, 5)[22:24].any() and not got.view(width, 5)[28:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_onehot_pooled_lookup_grouped(dtype):
    """K4's op with its registered gradient (tables and weights) on float32
    and bf16 tables, and its gradient equal to the autograd function the
    eager path launches."""
    rng = np.random.RandomState(7)
    tables = [torch.from_numpy(rng.randn(n, 4).astype(np.float32)).to(dtype).requires_grad_()
              for n in (20, 7)]
    idx = torch.from_numpy(rng.randint(-1, 21, size=(3, 5, 2)).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(0, 1, (3, 5, 2)).astype(np.float32)).requires_grad_()
    args = (tables, [0, 2], [0, 8], 12, idx, mask)
    torch.library.opcheck(torch.ops.dqrm.onehot_pooled_lookup_grouped.default, args)
    g = torch.from_numpy(rng.randn(3, 5, 4).astype(np.float32))
    got = torch.ops.dqrm.onehot_pooled_lookup_grouped(*args).view(3, 5, 4)
    want = toh.onehot_pooled_lookup_grouped(toh.make_onehot_lookup_group(tables, (0, 2)), idx, mask)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got, [*tables, mask], g), torch.autograd.grad(want, [*tables, mask], g)):
        assert torch.equal(a, b)


def test_onehot_op_refuses_a_gradient_off_its_slots():
    """Tables writing columns other than their slots of a [T, B, D]
    output take no gradient, as the eager wrapper refuses them."""
    t = torch.zeros((5, 4), requires_grad=True)
    ids = torch.zeros((2, 3, 1), dtype=torch.int32)
    out = torch.ops.dqrm.onehot_pooled_lookup_grouped([t], [0], [4], 8, ids, None)
    with pytest.raises(ValueError, match="slots"):
        out.sum().backward()


def test_traced_lookup_into_out_keeps_the_other_blocks():
    """Under tracing a grouped lookup given `out` returns a new tensor:
    the group's blocks, and `out`'s values elsewhere (serving's K4 blocks
    merge into K2's output so)."""
    rng = np.random.RandomState(8)
    tables = [torch.from_numpy(rng.randn(n, 4).astype(np.float32)) for n in (9, 6)]
    group = toh.make_onehot_lookup_group(tables, (2, 0))

    class M(torch.nn.Module):
        def forward(self, ids, out):
            return toh.onehot_pooled_lookup_grouped_fwd(group, ids, None, out=out)

    ids = torch.from_numpy(rng.randint(0, 6, size=(3, 5, 2)).astype(np.int32))
    out = torch.full((3, 5, 4), -2.0)
    got = torch.export.export(M(), (ids, out)).module()(ids, out)
    want = toh.onehot_pooled_lookup_grouped_fwd(group, ids, None, out=out.clone())
    assert torch.equal(got, want) and bool((got[1] == -2.0).all())


def test_artifact_takes_only_its_batch_size(tmp_path):
    """The loaded program's tensors lie on the model's device (here the
    CPU), and it takes the export's batch size only, as JAX's fixed
    ShapeDtypeStructs do."""
    _, tc, _, tsm = models("int4_mlp8")
    path = tserving.export_stablehlo(tsm, B, str(tmp_path / "s.pt2"))
    assert {t.device.type for t in torch.export.load(path).state_dict.values()} == {"cpu"}
    fn = tserving.load_stablehlo(path)
    b = tsyn.random_batch(tc, B * 2, np.random.RandomState(9), device="cpu")
    with pytest.raises(Exception, match="32"):
        fn(b.dense, b.indices)
