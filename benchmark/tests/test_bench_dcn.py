"""The DLRM-DCNv2 cell's own pieces: its driver's planted faults come out not
correct, a program without the model's fields stops at set-up before
drawing anything, the roofline's counts at the published widths, the
metric readers, and the reference's cross layers."""

from __future__ import annotations

import json

import pytest
import torch

import cells
import port
import roofline_dcn
import weights
from conftest import ROOT, RUN_DRIVERS, run_cell

DCN = [w for w, d in RUN_DRIVERS.items() if d == "drive_train_dcn"]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "mlperf-dlrm-dcnv2-int4.json").read_text())


def _state_unchanged(make):
    def megastep(cfg, tc, k, device):
        real = make(cfg, tc, k, device)

        def multi(state, batches):
            copy = port.train_state(cfg, tc, {
                part: ([t.clone() for t in v] if part == "emb" else [{n: x.clone() for n, x in l.items()} for l in v])
                for part, v in state.params.items()})
            _, loss = real(copy, batches)
            multi.losses = real.losses
            return state, loss

        multi.step = None
        return multi

    return megastep


def _half_batch(make):
    def megastep(cfg, tc, k, device):
        real = make(cfg, tc, k, device)

        def multi(state, b):
            h = b.dense.shape[1] // 2
            out = real(state, port.Batch(b.dense[:, :h], b.indices[:, :h], b.labels[:, :h], None))
            multi.losses = real.losses
            return out

        multi.step = None
        return multi

    return megastep


@pytest.mark.parametrize("workload", DCN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_train_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    monkeypatch.setattr(port, "megastep", fault(port.megastep))
    rc, line, _ = run_cell(tiny_root, workload)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("workload", DCN)
def test_a_program_without_the_fields_stops_at_set_up(tiny_root, monkeypatch, workload):
    """As the parent program does: its DLRMConfig has no `dcn_num_layers`."""
    drawn = []

    def old_config(**kw):
        if "dcn_num_layers" in kw:
            raise TypeError("DLRMConfig.__init__() got an unexpected keyword argument 'dcn_num_layers'")
        raise AssertionError("not reached")

    monkeypatch.setattr(port, "DLRMConfig", old_config)
    monkeypatch.setattr(weights, "params", lambda *a, **k: drawn.append(1))
    with pytest.raises(TypeError, match="dcn_num_layers"):
        run_cell(tiny_root, workload)
    assert not drawn


def test_step_counts_at_the_published_widths():
    model, quant = CONFIG["model"], CONFIG["quant"]
    one = roofline_dcn.train_steps(model, quant, 8192, 1, 0)
    assert one["flop"] == 3 * 2 * 8192 * 16_030_464  # 0.788 TFLOP: cross 66%, top 33%, bottom 1%
    cross = 3 * 2 * 8192 * 3 * 2 * 3456 * 512
    assert abs(cross / one["flop"] - 0.662) < 0.001
    assert one["bound_by"] == "operations"
    assert roofline_dcn.dense_params(model) == 170_496 + 896 + 5_243_136 + 2_817 + 3 * (2 * 3456 * 512 + 3456)
    k1 = roofline_dcn.k1_step(model, CONFIG["train"], 8192)
    # 16 tables of at most 20000 rows, 61,873 rows, 36 ids a sample
    assert k1["bytes"] == 61_873 * 128 * 4 + 16 * 8192 * 128 * 4 + 36 * 8192 * 4
    assert sum(CONFIG["model"]["multi_hot_sizes"]) == 214
    assert CONFIG["sizes"]["table_rows"] == sum(model["table_sizes"]) == 29_184_588


def test_distinct_rows_per_table_and_batch():
    ids = torch.tensor([[[0, 1, 1, 5], [2, 2, 0, 5]], [[3, 3, 3, 4], [0, 1, 2, 3]]], dtype=torch.int32)
    # widths 1 and 3: table 0 takes column 0, table 1 columns 1-3 (ids of different tables never merge)
    assert roofline_dcn.distinct_rows(ids, (1, 3)).tolist() == [2 + 4, 2 + 4]
    assert roofline_dcn.distinct_rows(ids, (4,)).tolist() == [4, 5]


def test_bag_pad_share_reads_the_counters():
    reader = cells.reader("bag_pad_share.train")
    assert reader.read({"traced": {"bags": {"bag_ids": 300, "bag_slots": 400}}}) == 25.0
    assert reader.read({"traced": {"bags": {"bag_ids": 400, "bag_slots": 400}}}) == 0.0
    assert reader.read({"traced": {"bags": None}}) is None  # a program without them
    assert reader.read({"traced": None}) is None


def test_cross_layers_are_drawn_again_bit_for_bit():
    import drive_train_dcn

    model = {**CONFIG["model"], "mlp_top": [48, 16, 1], "dcn_low_rank_dim": 4}
    a, b = (drive_train_dcn.cross(model, 2**31 + 5, torch.device("cpu")) for _ in range(2))
    assert len(a) == 3 and all(torch.equal(x[n], y[n]) for x, y in zip(a, b) for n in "vwb")
    assert a[0]["v"].shape == (4, 48) and a[0]["w"].shape == (48, 4) and not a[0]["b"].any()
    assert not torch.equal(a[0]["v"], a[1]["v"])
