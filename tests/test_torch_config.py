"""The port's config module equals the JAX package's, field for field."""

import dataclasses

import pytest
import torch

from deep_quantized_recommendation_model_dqrm_tpu import config as jcfg
from deep_quantized_recommendation_model_dqrm_tpu_torch import config as tcfg

torch.set_num_threads(1)

QUANT = dict(enabled=True, embedding_bit=8, weight_bit=8, scale_update_period=50)
CASES = {
    "dlrm_default": lambda m: m.DLRMConfig(),
    "quant_default": lambda m: m.QuantConfig(),
    "train_default": lambda m: m.TrainConfig(),
    "kaggle": lambda m: m.kaggle_config(),
    "terabyte": lambda m: m.terabyte_config(),
    "kaggle_quant": lambda m: m.kaggle_config(m.QuantConfig(**QUANT)),
    "terabyte_quant": lambda m: m.terabyte_config(m.QuantConfig(**QUANT)),
    "train_replaced": lambda m: m.TrainConfig().replace(batch_size=512, ranking_range=True),
    "md": lambda m: dataclasses.replace(m.kaggle_config(), md_flag=True, md_threshold=1000),
    "md_round": lambda m: dataclasses.replace(
        m.kaggle_config(), md_flag=True, md_round_dims=True, md_temperature=0.2
    ),
    "qr_cat": lambda m: m.DLRMConfig(
        table_sizes=(512, 300, 64), embedding_dim=8, mlp_bot=(4, 16, 8),
        mlp_top=(32, 8, 1), interaction="cat", qr_flag=True, qr_threshold=200,
    ),
}


# The port's own DLRMConfig fields (DLRM-DCNv2's cross network and
# per-table bag widths), which the JAX package lacks, at their defaults.
PORT_ONLY = {"dcn_num_layers": 0, "dcn_low_rank_dim": 0, "multi_hot_sizes": None}


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_fields_equal(name):
    j, t = CASES[name](jcfg), CASES[name](tcfg)
    assert type(t).__name__ == type(j).__name__
    want = dataclasses.asdict(j)
    if isinstance(t, tcfg.DLRMConfig):
        want = {**want, **PORT_ONLY}
    assert dataclasses.asdict(t) == want
    if isinstance(t, tcfg.DLRMConfig):
        assert t.num_tables == j.num_tables and t.num_dense == j.num_dense
        assert t.top_input_dim == j.top_input_dim
        assert t.md_dims() == j.md_dims()
        assert [t.table_kind(k) for k in range(t.num_tables)] == [
            j.table_kind(k) for k in range(j.num_tables)
        ]


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(interaction="sum"),
        dict(table_dtype="float16"),
        dict(loss_function="hinge"),
        dict(embedding_dim=8),  # dot interaction needs mlp_bot[-1] == dim
        dict(qr_flag=True, md_flag=True),
    ],
)
def test_config_rejects_like_jax(kwargs):
    with pytest.raises(ValueError):
        jcfg.DLRMConfig(**kwargs)
    with pytest.raises(ValueError):
        tcfg.DLRMConfig(**kwargs)


def test_parsers_match():
    assert tcfg.dash_separated_ints("13-512-256") == jcfg.dash_separated_ints("13-512-256")
    assert tcfg.dash_separated_floats("0.5-0.25") == jcfg.dash_separated_floats("0.5-0.25")
