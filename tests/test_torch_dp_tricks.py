"""The port's data-parallel engines under the model options and the
ranking-range policy, against the JAX package's on the CPU: QR and MD
tables, fixed and learned pooling weights (`v_W`, learned also under PACT
and with every table QR), `compute_dtype="bfloat16"`, bf16 tables and
`ranking_range` with and without QR tables, each at grad bits 32 and at
bits 8 with error compensation; dp-nosync with QR and with bf16 tables;
the pseudo engine with fixed `v_W` and with bf16 tables; and the refusals
both packages share.

The world-2 jobs run once, on two gloo ranks (the worker of
tests/test_torch_comm_grad.py, with two job kinds of this file), from
states and batches made with the JAX package; the JAX side runs on
`make_mesh(2)`. Bounds: losses rtol 1e-4, parameters atol 1e-5 (the dp
parity bounds). bf16 tables, where each package adds rounded updates in
its own order: a row that the global batch touched c times lies within
max(c, 1) bf16 ulps of JAX's (tests/test_torch_bf16.py), from JAX's state
after its first scale refresh, one step at a time (JAX's compiled refresh
divides by the reciprocal of 7, which flips INT4 roundings at .5 ties on
bf16 values). The pseudo engine on bf16 tables departs from JAX's on
purpose: K1 and K5 sum a row's updates in float32 and round once, where
JAX's scatter rounds each; the same bound holds it."""

import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bf16 as tb
import test_torch_comm_grad as cg
from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu.parallel import comm_grad as jcg
from deep_quantized_recommendation_model_dqrm_tpu.parallel import make_mesh
from deep_quantized_recommendation_model_dqrm_tpu.parallel import pseudo as jpseudo
from deep_quantized_recommendation_model_dqrm_tpu.parallel import ranking_range as jrr
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import comm_grad as tcg
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import pseudo as tpseudo
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools.jax_weights import (
    pseudo_state_from_numpy,
    replica_state_to_numpy,
)

torch.set_num_threads(1)

QAT = cg.QAT
STEPS = cg.STEPS
# K1 on the 64-, 30- and 7-row tables, K5 on the 200-row table, a scatter for 500
ROUTES = cg.ROUTES
BITS = {"bits32": dict(grad_quant_bits=32), "bits8_ec": dict(grad_quant_bits=8, error_compensation=True)}
QR = dict(qr_flag=True, qr_threshold=100)  # the 200- and 500-row tables
RR = dict(ranking_range=True, **ROUTES)

# name -> (model options, quant kwargs, TrainConfig kwargs, v_W seed)
OPTIONS = {
    "qr": (QR, QAT, {}, None),
    "md": (dict(md_flag=True, md_threshold=100), QAT, {}, None),
    "vw_fixed": (dict(weighted_pooling="fixed"), QAT, ROUTES, 7),
    "vw_learned": (dict(weighted_pooling="learned"), QAT, ROUTES, None),
    "vw_learned_pact": (dict(weighted_pooling="learned"), dict(QAT, quant_scheme="pact"), {}, None),
    "all_qr_vw_learned": (dict(qr_flag=True, qr_threshold=5, qr_operation="add",
                               weighted_pooling="learned"), QAT, {}, None),
    "bf16_compute": (dict(compute_dtype="bfloat16"), QAT, ROUTES, None),
    "ranking": ({}, QAT, RR, None),
    "ranking_qr": (QR, QAT, RR, None),
}
DP_CASES = {f"{name}_{b}": (opts, quant, dict(tc, **bk), vw)
            for name, (opts, quant, tc, vw) in OPTIONS.items() for b, bk in BITS.items()}
BF16 = dict(table_dtype="bfloat16")
BF16_CASES = {f"bf16_tables_{b}": (BF16, QAT, dict(ROUTES, **bk), None) for b, bk in BITS.items()}
NOSYNC_CASES = {"nosync_qr": (QR, QAT, {}, None), "nosync_bf16_tables": (BF16, QAT, {}, None)}

EXTRA_KINDS = '''
    from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import ranking_range

    def dp_modes(job):
        seen = []
        orig = ranking_range.assign_bit_widths

        def record(ranges, scales, step, hi, int8):
            modes = orig(ranges, scales, step, hi, int8)
            seen.append((ranges.numpy().copy(), scales.numpy().copy(), step, modes.numpy().copy()))
            return modes

        ranking_range.assign_bit_widths = record
        try:
            out = dp(job)
        finally:
            ranking_range.assign_bit_widths = orig
        return dict(out, modes=seen)

    def dp_onestep(job):
        cfg, tc = configs(job)
        step = comm_grad.make_dp_train_step(cfg, tc, device="cpu")
        out = []
        for st, b in zip(job["states"], job["batches"]):
            state, loss = step(state_of(st), local(b))
            out.append({"loss": float(loss), "state": replica_state_to_numpy(state)})
        return out

    RUN = {"dp": dp, "nosync": nosync, "dp_modes": dp_modes, "dp_onestep": dp_onestep}
'''
WORKER = cg.WORKER.replace("\nmultihost.init_distributed(",
                           textwrap.dedent(EXTRA_KINDS) + "\nmultihost.init_distributed(", 1)
assert WORKER != cg.WORKER


def cfg_kw(opts):
    return dict(cg.CFG_KW, **opts)


def jax_configs(opts, quant, tc_kw):
    qc = jcfg.QuantConfig(**quant) if quant else jcfg.QuantConfig()
    return jcfg.DLRMConfig(quant=qc, **cfg_kw(opts)), jcfg.TrainConfig(**dict(cg.TC_KW, **tc_kw))


def jax_state(jc, jtc, vw_seed):
    js = jcg.init_dp_state(jc, jtc, seed=0)
    if vw_seed is not None:  # pooling weights other than ones (an imported checkpoint's)
        rng = np.random.RandomState(vw_seed)
        vw = [jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32)) for n in jc.table_sizes]
        js = js._replace(params={**js.params, "v_W": vw})
    return js


def job_of(kind, case, seed):
    opts, quant, tc_kw, vw_seed = case
    jc, jtc = jax_configs(opts, quant, tc_kw)
    return {"kind": kind, "cfg": cfg_kw(opts), "quant": quant, "tc": dict(cg.TC_KW, **tc_kw),
            "state": cg.plain_state(jax_state(jc, jtc, vw_seed)),
            "batches": [cg.np_batch(b) for b in cg.batches(jc, seed)], "seed": seed}


def jax_run(case, seed, make=jcg.make_dp_train_step, steps=None):
    """JAX's states before each step and after the last, and its losses."""
    opts, quant, tc_kw, vw_seed = case
    jc, jtc = jax_configs(opts, quant, tc_kw)
    mesh = make_mesh(2)
    js = jax_state(jc, jtc, vw_seed)
    step = make(jc, jtc, mesh)
    states, losses = [], []
    for b in cg.batches(jc, seed, n=steps or STEPS):
        states.append(cg.plain_state(js))
        js, loss = step(js, b)
        losses.append(float(loss))
    return js, states, losses, mesh


def bf16_job(name, case, seed):
    """One dp step at a time from JAX's states after its first step (the
    refresh at step 0), with no refresh in the steps compared."""
    opts, quant, tc_kw, _ = case
    js, states, losses, _ = jax_run((opts, dict(quant, scale_update_period=1000), tc_kw, None), seed)
    jc, _ = jax_configs(opts, quant, tc_kw)
    b = cg.batches(jc, seed)
    return {"kind": "dp_onestep", "cfg": cfg_kw(opts), "quant": dict(quant, scale_update_period=1000),
            "tc": dict(cg.TC_KW, **tc_kw), "states": states[1:], "batches": [cg.np_batch(x) for x in b[1:]],
            "jax_after": states[2:] + [cg.plain_state(js)], "jax_losses": losses[1:], "jax_batches": b[1:]}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("world2_tricks"))
    jobs = {}
    for i, (name, case) in enumerate(DP_CASES.items()):
        jobs[name] = job_of("dp_modes" if case[2].get("ranking_range") else "dp", case, seed=60 + i)
    for i, (name, case) in enumerate(BF16_CASES.items()):
        jobs[name] = bf16_job(name, case, seed=90 + i)
    for i, (name, case) in enumerate(NOSYNC_CASES.items()):
        jobs[name] = dict(job_of("nosync", case, seed=95 + i), sync=True)
    sent = {k: {kk: vv for kk, vv in v.items() if not kk.startswith("jax_")} for k, v in jobs.items()}
    return jobs, cg.run_world2(tmp, sent, worker=WORKER)


def f32_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def assert_params_close(jparams, got, scaled=False):
    """Within atol 1e-5; `scaled` (PACT) within 1e-5 x max(1, |value|), the
    bound chip_smoke.py holds PACT to: its tables run to hundreds."""
    jt = jax.tree_util.tree_leaves(f32_tree(jparams))
    nt = jax.tree_util.tree_leaves(got)
    assert len(jt) == len(nt)
    for a, b in zip(jt, nt):
        assert a.shape == b.shape
        tol = cg.PARAM_ATOL * (np.maximum(1.0, np.abs(a)) if scaled else 1.0)
        assert (np.abs(b - a) <= tol).all(), float(np.abs(b - a).max())


def assert_ec_close(jec, got, flip_share=0.01):
    """The error-feedback residuals within atol 1e-5, but for at most 1% of
    the elements: where the two packages' gradients, ulps apart, fall on the
    two sides of an INT8 rounding boundary, the residual jumps by one
    quantum and carries into the next steps (seen under PACT with learned
    `v_W`); the parameters it moves stay within their bound."""
    jt = [np.asarray(a) for a in jax.tree_util.tree_leaves(jec)]
    nt = jax.tree_util.tree_leaves(got)
    assert [a.shape for a in jt] == [b.shape for b in nt]
    beyond = sum(int((np.abs(a - b) > cg.PARAM_ATOL).sum()) for a, b in zip(jt, nt))
    assert beyond <= flip_share * sum(a.size for a in jt), beyond


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_options_world2_match_jax(world2, name):
    """4 dp steps at world 2 from JAX's state on its batches: both ranks
    report the same losses, within rtol 1e-4 of JAX's on `make_mesh(2)`,
    and end with parameters and residuals within atol 1e-5 of JAX's; with
    `ranking_range` every step's modes equal those JAX's policy gives for
    the same ranges, scales and step, the mode counts are round(0.2 T) HI
    and round(0.3 T) INT8, and no QR/MD table is ranked."""
    jobs, (out0, out1) = world2
    case = DP_CASES[name]
    js, _, jlosses, _ = jax_run(case, jobs[name]["seed"])
    assert out0[name]["losses"] == out1[name]["losses"]
    np.testing.assert_allclose(out0[name]["losses"], jlosses, rtol=cg.LOSS_RTOL)
    got = out0[name]["state"]
    pact = case[1].get("quant_scheme") == "pact"
    assert_params_close(js.params, got["params"], scaled=pact)
    assert_ec_close(js.ec, got["ec"])
    assert int(got["qstate"]["step"]) == STEPS
    if case[0].get("weighted_pooling") == "learned":
        moved = sum(int((v != 1).sum()) for v in got["params"]["v_W"])
        assert moved > 0
    if case[2].get("ranking_range"):
        modes = out0[name]["modes"]
        assert [m[2] for m in modes] == list(range(STEPS))
        t_dense = 3 if case[0].get("qr_flag") else 5
        for ranges, scales, step, m in modes:
            want = np.asarray(jrr.assign_bit_widths(jnp.asarray(ranges), jnp.asarray(scales), jnp.int32(step)))
            np.testing.assert_array_equal(m, want)
            assert m.shape == (t_dense,)
            assert (m == jrr.HI).sum() == round(0.2 * t_dense) and (m == jrr.INT8).sum() == round(0.3 * t_dense)
        for a, b in zip(out0[name]["modes"], out1[name]["modes"]):
            np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_dp_bf16_tables_world2_one_step_from_jax(world2, name):
    """bf16 tables under dp at world 2 (K1, K5 and scatter routes), 3 steps
    each from JAX's state before it: losses within rtol 1e-4, the MLP within
    atol 1e-5, each bf16 table row within max(c, 1) ulps of JAX's, c the
    times the global batch touched it (untouched rows equal)."""
    jobs, (out0, out1) = world2
    job = jobs[name]
    for i, (want, r0, r1) in enumerate(zip(job["jax_after"], out0[name], out1[name])):
        assert r0["loss"] == r1["loss"]
        np.testing.assert_allclose(r0["loss"], job["jax_losses"][i], rtol=cg.LOSS_RTOL)
        for part in ("bot", "top"):
            cg.assert_tree_close(want["params"][part], r0["state"]["params"][part], cg.PARAM_ATOL)
        tparams = {"emb": [torch.from_numpy(t).to(torch.bfloat16) for t in r0["state"]["params"]["emb"]]}
        tb.assert_tables_match(want["params"], tparams, np.asarray(job["jax_batches"][i].indices),
                               f"{name} step {i + 1}", exact_once=False)
        for a, b in zip(r0["state"]["params"]["emb"], r1["state"]["params"]["emb"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(NOSYNC_CASES))
def test_dp_nosync_options_world2_match_jax(world2, name):
    """dp-nosync with QR tables and with bf16 tables, 4 steps and a weight
    sync: losses against JAX's, the synced parameters against JAX's synced
    replicas (bf16 tables within max(c, 1) ulps of a row touched c times in
    the 4 global batches: each rank's step rounds once, the sync's sum
    once; the bound counts 2c), and the two
    replicas equal bit for bit after the sync."""
    jobs, (out0, out1) = world2
    case = NOSYNC_CASES[name]
    js, _, jlosses, mesh = jax_run(case, jobs[name]["seed"], make=jcg.make_dp_nosync_train_step)
    js = jcg.make_weight_sync(mesh)(js)
    np.testing.assert_allclose(out0[name]["losses"], jlosses, rtol=cg.LOSS_RTOL)
    assert out0[name]["losses"] == out1[name]["losses"]
    got = out0[name]["state"]["params"]
    if case[0].get("table_dtype") == "bfloat16":
        for part in ("bot", "top"):
            cg.assert_tree_close(js.params[part], got[part], cg.PARAM_ATOL)
        idx = np.concatenate([np.asarray(b.indices) for b in cg.batches(jax_configs(*case[:3])[0],
                                                                         jobs[name]["seed"])], axis=1)
        tparams = {"emb": [torch.from_numpy(t).to(torch.bfloat16) for t in got["emb"]]}
        tb.assert_tables_match(f32_tree(js.params), tparams, np.concatenate([idx, idx], axis=1), name,
                               exact_once=False)
    else:
        assert_params_close(js.params, got)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(out1[name]["state"]["params"])):
        np.testing.assert_array_equal(a, b)


def test_ranking_range_all_qr_raises_as_jax():
    """A model whose every table is QR leaves the policy nothing to govern:
    both packages raise the same ValueError before any group is needed."""
    case = (dict(qr_flag=True, qr_threshold=5), QAT, RR, None)
    jc, jtc = jax_configs(*case[:3])
    with pytest.raises(ValueError) as want:
        jcg.make_dp_train_step(jc, jtc, make_mesh(1))
    tc_cfg = tcfg.DLRMConfig(quant=tcfg.QuantConfig(**QAT), **cfg_kw(case[0]))
    with pytest.raises(ValueError) as got:
        tcg.make_dp_train_step(tc_cfg, tcfg.TrainConfig(**dict(cg.TC_KW, **RR)), device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The pseudo engine, in this process
# ---------------------------------------------------------------------------

PSEUDO_N, PSEUDO_B, PSEUDO_STEPS = 4, 64, 3


def pseudo_configs(opts, tc_kw, quant=QAT):
    out = []
    for m in (jcfg, tcfg):
        out.append((m.DLRMConfig(quant=m.QuantConfig(**quant), **cfg_kw(opts)),
                    m.TrainConfig(batch_size=PSEUDO_B, learning_rate=0.05, weight_sync_period=0,
                                  grad_quant_bits=8, error_compensation=True, **tc_kw)))
    return out


@pytest.mark.parametrize("opts", [dict(weighted_pooling="fixed"), BF16], ids=["vw_fixed", "bf16_tables"])
def test_pseudo_options_match_jax(opts):
    """4 simulated workers, 3 steps from JAX's state (bf16 tables from its
    state after its first step, one step at a time), with the K1 and K5
    routes (their plain versions here) and a scatter: losses within 2e-5,
    the MLP and residuals within atol 2e-5 (tests/test_torch_pseudo.py),
    float32 tables within 2e-5, and bf16 tables within max(c, 1) ulps of a
    row touched c times: the port's K1 and K5 round a row's float32 sum
    once, JAX's scatter each update."""
    bf16 = opts == BF16
    (jc, jtc), (tc_cfg, ttc) = pseudo_configs(opts, ROUTES, dict(QAT, scale_update_period=1000) if bf16 else QAT)
    js = jpseudo.init_pseudo_state(jc, jtc, seed=0)
    jstep = jpseudo.make_pseudo_train_step(jc, jtc, PSEUDO_N)
    tstep = tpseudo.make_pseudo_train_step(tc_cfg, ttc, PSEUDO_N, device="cpu")
    batches = cg.batches(jc, 5, n=PSEUDO_STEPS + 1, b=PSEUDO_B)
    if bf16:
        js, _ = jstep(js, batches[0])
    batches = batches[1:]
    to_np = lambda s: types.SimpleNamespace(  # noqa: E731
        params=jax.tree_util.tree_map(np.asarray, s.params), ec=jax.tree_util.tree_map(np.asarray, s.ec),
        qstate=s.qstate)
    ts = pseudo_state_from_numpy(to_np(js), "cpu")
    for i, b in enumerate(batches):
        if bf16:
            ts = pseudo_state_from_numpy(to_np(js), "cpu")
        js, jl = jstep(js, b)
        ts, tl = tstep(ts, cg.to_torch(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=2e-5)
        got = replica_state_to_numpy(ts)
        for part in ("bot", "top"):
            cg.assert_tree_close(js.params[part], got["params"][part], 2e-5)
        cg.assert_tree_close(js.ec, got["ec"], 2e-5)
        if bf16:
            tb.assert_tables_match(f32_tree(js.params), ts.params, np.asarray(b.indices), f"step {i}",
                                   exact_once=False)
            assert all(t.dtype == torch.bfloat16 for t in ts.params["emb"])
        else:
            cg.assert_tree_close(js.params["emb"], got["params"]["emb"], 2e-5)
            cg.assert_tree_close(js.params["v_W"], got["params"]["v_W"], 0)


@pytest.mark.parametrize("opts", [dict(weighted_pooling="learned"), QR, dict(md_flag=True, md_threshold=100),
                                  dict(QR, weighted_pooling="learned")],
                         ids=["vw_learned", "qr", "md", "qr_vw_learned"])
def test_pseudo_refusals_match_jax(opts):
    """Learned pooling weights and QR/MD tables: both pseudo engines raise
    NotImplementedError with the same message (learned v_W checked first)."""
    (jc, jtc), (tc_cfg, ttc) = pseudo_configs(opts, {})
    with pytest.raises(NotImplementedError) as want:
        jpseudo.make_pseudo_train_step(jc, jtc, PSEUDO_N)
    with pytest.raises(NotImplementedError) as got:
        tpseudo.make_pseudo_train_step(tc_cfg, ttc, PSEUDO_N, device="cpu")
    assert str(got.value) == str(want.value)
