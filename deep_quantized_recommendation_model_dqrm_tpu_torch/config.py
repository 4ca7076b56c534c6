"""Configuration dataclasses for the DQRM-TPU framework.

Replaces the reference's ~70-flag argparse surface duplicated across 20 training
scripts (reference: dlrm_s_pytorch.py:907-1021, dlrm_s_pytorch_comm_grad.py:
1027-1137) with typed, hashable configs that can be closed over by jitted
functions.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Optional, Tuple


def dash_separated_ints(value: str) -> Tuple[int, ...]:
    """Parse '13-512-256-64-16' into a tuple of ints.

    Reference behavior: dlrm_s_pytorch.py:736-747 (`dash_separated_ints`).
    """
    try:
        return tuple(int(v) for v in value.split("-"))
    except ValueError as e:
        raise ValueError(f"{value} is not a valid dash-separated list of ints") from e


def dash_separated_floats(value: str) -> Tuple[float, ...]:
    """Parse '0.5-0.25' into a tuple of floats (dlrm_s_pytorch.py:750-759)."""
    try:
        return tuple(float(v) for v in value.split("-"))
    except ValueError as e:
        raise ValueError(f"{value} is not a valid dash-separated list of floats") from e


@dataclass(frozen=True)
class QuantConfig:
    """Quantization-aware-training configuration.

    Mirrors the reference's QAT flags (dlrm_s_pytorch_comm_grad.py:1120-1137):
    `--quantization_flag`, `--embedding_bit`, `--weight_bit`,
    `--quantize_activation`, `--quantize_act_and_lin`, `--linear_channel`,
    plus the periodic scale-update period of the paper's §3.2.
    """

    enabled: bool = False
    # Bit widths. Reference defaults: INT4 embeddings + INT4 MLP weights.
    embedding_bit: int = 4
    weight_bit: int = 4
    bias_bit: int = 32
    activation_bit: int = 8
    # Quantize activations between MLP layers (QuantAct chains,
    # quant_modules.py:465-637); requires `quantize_mlp`.
    quantize_activation: bool = False
    # Quantize MLP weights at all (False = embedding-only QAT, paper Table 2).
    quantize_mlp: bool = True
    # Fake-quantize embedding pooled outputs (True = DQRM default). False =
    # MLP-only QAT: the regime the reference pseudo-multigpu script actually
    # runs (dlrm_s_pytorch_pseudo_multigpu.py:1115-1116 with
    # pretrain_and_quantize=False leaves the module-level full_precision_flag
    # False, and quant_modules.py:335-344 only quantizes when that flag is
    # True — inverted convention — so its embeddings stay full-precision).
    quantize_emb: bool = True
    # Per-output-channel MLP weight scales (`--linear_channel`,
    # quant_modules.py:106-112).
    mlp_channelwise: bool = False
    # Periodic scale update period for embedding tables (paper §3.2:
    # Kaggle 200, Terabyte 1000; quant_modules.py:279-291). 1 = every step.
    scale_update_period: int = 200
    # Integer feature interaction (`--modify_feature_interaction`,
    # dlrm_s_pytorch_comm_grad.py:744-792): quantize interaction inputs to
    # INT16 and compute the bmm on integers, rescaling by scale^2.
    modify_feature_interaction: bool = False
    interaction_bit: int = 16
    # Activation range tracking momentum (QuantAct, quant_modules.py:491).
    # -1.0 means running extremum min/max.
    act_range_momentum: float = 0.95
    # Percentile clipping of activation ranges (QuantAct act_percentile,
    # quant_modules.py:567-577): 0 = plain min/max; 99.9 cuts off 0.1%.
    act_percentile: float = 0.0
    # Alternate QAT schemes for baseline comparison (paper Table 3):
    # "hawq" (default DQRM), "pact" (DoReFa-style tanh STE,
    # quant_pact_dorefa.py), "lsq" (learned step size, quantizer/lsq.py).
    quant_scheme: str = "hawq"

    def __post_init__(self):
        if self.quant_scheme not in ("hawq", "pact", "lsq"):
            raise ValueError(f"unknown quant scheme {self.quant_scheme!r}")
        if self.quantize_activation and self.mlp_channelwise:
            # The reference's integer-activation chain broadcasts the bias
            # scale as fc_scale * prev_act_scale (quant_modules.py:131-135),
            # which requires per-tensor scales.
            raise ValueError(
                "quantize_activation requires per-tensor MLP scales "
                "(mlp_channelwise=False)"
            )
        if self.quantize_activation and self.quant_scheme != "hawq":
            # The reference's PACT/LSQ Linears take the plain forward path
            # (not the QuantAct scale chain): dlrm_s_pytorch_single_gpu_ysx
            # apply_mlp dispatches on isinstance(layer, QuantLinear), which
            # QuantLinearPACT/LSQ are not (ysx:576-640).
            raise ValueError(
                "quantize_activation is only supported with the hawq "
                "scheme (the reference pairs PACT/LSQ with the plain "
                "weight-quant forward)"
            )


def top_input_dim(num_tables: int, d: int, interaction: str, interact_itself: bool = False) -> int:
    """Input width of the top MLP for `num_tables` tables and a bottom MLP
    of output width `d` (`DLRMConfig.top_input_dim`)."""
    num_fea = num_tables + 1
    if interaction == "dot":
        offset = 1 if interact_itself else 0
        return (num_fea * (num_fea - 1)) // 2 + num_fea * offset + d
    return num_fea * d  # cat, and dcn's cross network, which keeps its width


@dataclass(frozen=True)
class DLRMConfig:
    """DLRM architecture configuration.

    Mirrors `DLRM_Net.__init__` (dlrm_s_pytorch.py:288-389): bottom MLP over
    dense features, per-table embedding lookups, pairwise interaction,
    top MLP ending in a sigmoid output.
    """

    # ln_emb: rows per sparse embedding table (`--arch-embedding-size`).
    table_sizes: Tuple[int, ...] = (4, 3, 2)
    # m_spa: embedding dimension (`--arch-sparse-feature-size`).
    embedding_dim: int = 4
    # ln_bot / ln_top (`--arch-mlp-bot/top`); bot[0] = dense feature count,
    # top[-1] = 1 (the click logit).
    mlp_bot: Tuple[int, ...] = (4, 3, 4)
    mlp_top: Tuple[int, ...] = (8, 4, 2, 1)
    # `--arch-interaction-op`: "dot" | "cat" | "dcn". "dcn" (a port-only
    # option, MLPerf Training's DLRM-DCNv2: torchrec's `LowRankCrossNet`)
    # concatenates the bottom-MLP output with the pooled lookups, as "cat"
    # does, and runs `dcn_num_layers` low-rank cross layers of rank
    # `dcn_low_rank_dim` over that before the top MLP.
    interaction: str = "dot"
    # `--arch-interaction-itself`: include self-interaction diagonal.
    interact_itself: bool = False
    # Sigmoid placement: reference puts Sigmoid on layer `sigmoid_top`
    # (last top layer) and ReLU elsewhere (dlrm_s_pytorch.py:229-233).
    # We always emit logits from the top MLP and apply sigmoid in
    # predict/loss for numerical stability; `loss_threshold` clamps
    # probabilities like dlrm_s_pytorch.py:607-614.
    loss_threshold: float = 0.0
    # `--loss-function` {mse,bce,wbce} + `--loss-weights` (wbce per-class
    # weights, dlrm_s_pytorch.py:934-937, :376-388). The DQRM scripts train
    # with bce; mse/wbce are the upstream options.
    loss_function: str = "bce"
    loss_weights: Tuple[float, float] = (1.0, 1.0)
    # Max pooling size per lookup (Criteo = 1 index per feature). P>1
    # batches use a mask for variable-length bags.
    pooling_size: int = 1
    # Cross layers and their rank under interaction="dcn" (torchrec's
    # `--dcn_num_layers`, `--dcn_low_rank_dim`).
    dcn_num_layers: int = 0
    dcn_low_rank_dim: int = 0
    # Per-table fixed bag widths (torchrec's `--multi_hot_sizes`; a
    # port-only option): table k pools exactly multi_hot_sizes[k] ids a
    # sample, and a batch's ids are one [B, S] tensor, S the widths' sum,
    # table k's in the columns `bags()` gives (no padding, no mask).
    # None keeps the [T, B, P] layout at `pooling_size`.
    multi_hot_sizes: Optional[Tuple[int, ...]] = None
    # Sparse-index hashing modulus (`--max-ind-range`): applied in data
    # pipeline, recorded here for checkpoints.
    max_ind_range: int = -1
    # Embedding-table parameter dtype: "float32" (reference parity) or
    # "bfloat16" — halves HBM for the master tables (Terabyte fp32 is
    # 12.6 GB, tight on a 16 GB chip); QAT scales/fake-quant run in fp32
    # either way, and under INT4 QAT the bf16 master loses nothing the
    # 4-bit grid would keep.
    table_dtype: str = "float32"
    # MLP/interaction matmul compute dtype: "float32" (reference parity) or
    # "bfloat16" — operands are cast to bf16 at each matmul (fp32 master
    # weights, fp32 accumulation via preferred_element_type) so the MXU runs
    # at its native 2x bf16 rate. Affects the FP32 and weight-QAT MLP paths
    # and the dot interaction's bmm; the integer-activation chain keeps fp32
    # (its ste_round semantics are exact-integer). The reference has no
    # analogue (CUDA fp32 throughout); this is the TPU-first option for
    # large-batch Terabyte training.
    compute_dtype: str = "float32"
    # TPU-native optimization (no reference counterpart): plain (non-trick)
    # tables with at most this many rows run the pooled lookup as an MXU
    # one-hot matmul (ops/pallas/onehot_update.py) instead of the
    # latency-bound serial row gather. 0 disables. Identical semantics;
    # fp32 accumulation regardless of table_dtype.
    onehot_lookup_max_rows: int = 0
    # Per-row pooling weights v_W_l (`--weighted-pooling`,
    # dlrm_s_pytorch.py:276-281, :360-366): None | "fixed" (ones, frozen) |
    # "learned" (trainable parameter).
    weighted_pooling: Optional[str] = None
    # Quotient-remainder compositional embeddings (`--qr-flag` etc.,
    # dlrm_s_pytorch.py:928-931; tricks/qr_embedding_bag.py:25): tables with
    # rows > qr_threshold are replaced by two small composed tables. QR
    # tables stay full-precision even under QAT (reference create_emb
    # ordering, dlrm_s_pytorch_comm_grad.py:360-383).
    qr_flag: bool = False
    qr_operation: str = "mult"
    qr_collisions: int = 4
    qr_threshold: int = 200
    # Mixed-dimension embeddings (`--md-flag` etc., dlrm_s_pytorch.py:
    # 924-927 + md_solver at :1202; tricks/md_embedding_bag.py:20,63):
    # tables with rows > md_threshold get a reduced dim from the alpha-power
    # rule + a projection back to embedding_dim.
    md_flag: bool = False
    md_threshold: int = 200
    md_temperature: float = 0.3
    md_round_dims: bool = False
    quant: QuantConfig = QuantConfig()

    def __post_init__(self):
        if self.table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported table_dtype {self.table_dtype!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unsupported compute_dtype {self.compute_dtype!r}"
            )
        if self.loss_function not in ("mse", "bce", "wbce"):
            raise ValueError(
                f"loss_function must be mse|bce|wbce, got "
                f"{self.loss_function!r}"
            )
        if self.weighted_pooling not in (None, "fixed", "learned"):
            raise ValueError(
                f"weighted_pooling must be None|fixed|learned, got "
                f"{self.weighted_pooling!r}"
            )
        if self.interaction not in ("dot", "cat", "dcn"):
            raise ValueError(
                f"unsupported interaction {self.interaction!r}"
            )  # dlrm_s_pytorch.py:500-508
        if self.interaction == "dcn":
            self._check_dcn()
        elif self.dcn_num_layers or self.dcn_low_rank_dim:
            raise ValueError("dcn_num_layers and dcn_low_rank_dim need interaction='dcn'")
        if self.multi_hot_sizes is not None:
            self._check_multi_hot()
        if self.mlp_bot[-1] != self.embedding_dim and self.interaction == "dot":
            raise ValueError(
                "bottom MLP output dim must equal embedding dim for dot "
                f"interaction: {self.mlp_bot[-1]} != {self.embedding_dim}"
            )  # mirrors arch sanity checks dlrm_s_pytorch.py:1161-1198
        if self.qr_flag and self.qr_operation not in ("mult", "add", "concat"):
            raise ValueError(f"unknown qr_operation {self.qr_operation!r}")
        if self.qr_flag and self.md_flag:
            raise ValueError("qr_flag and md_flag are mutually exclusive")

    def _check_dcn(self) -> None:
        if self.dcn_num_layers < 1 or self.dcn_low_rank_dim < 1:
            raise ValueError(
                "interaction='dcn' needs dcn_num_layers >= 1 and dcn_low_rank_dim >= 1, got "
                f"{self.dcn_num_layers} and {self.dcn_low_rank_dim}")
        if self.mlp_bot[-1] != self.embedding_dim:
            raise ValueError(
                "bottom MLP output dim must equal embedding dim for the dcn interaction: "
                f"{self.mlp_bot[-1]} != {self.embedding_dim}")
        self.validate_top()  # the cross network keeps the concatenation's (T + 1) d
        qc = self.quant
        if qc.enabled and (qc.quant_scheme != "hawq" or qc.quantize_activation
                           or qc.modify_feature_interaction):
            raise ValueError(
                "interaction='dcn' runs HAWQ weight-only QAT: no pact/lsq scheme, "
                "quantize_activation or modify_feature_interaction")
        if self.qr_flag or self.md_flag:
            raise ValueError("interaction='dcn' takes plain tables (no qr_flag, md_flag)")

    def _check_multi_hot(self) -> None:
        if len(self.multi_hot_sizes) != self.num_tables or min(self.multi_hot_sizes) < 1:
            raise ValueError(
                f"multi_hot_sizes needs one width >= 1 for each of the {self.num_tables} tables, "
                f"got {self.multi_hot_sizes}")
        if (self.weighted_pooling is not None or self.qr_flag or self.md_flag
                or self.onehot_lookup_max_rows):
            raise ValueError(
                "multi_hot_sizes takes plain tables with unweighted sum pooling (no "
                "weighted_pooling, qr_flag, md_flag or onehot_lookup_max_rows)")
        if self.quant.enabled and self.quant.quant_scheme != "hawq":
            raise ValueError("multi_hot_sizes runs HAWQ QAT only")

    def bags(self) -> Optional[Tuple[Tuple[int, int], ...]]:
        """Each table's (first column, width) in a [B, S] id tensor under
        `multi_hot_sizes`; None for the [T, B, P] layout."""
        if self.multi_hot_sizes is None:
            return None
        cols = itertools.accumulate((0,) + tuple(self.multi_hot_sizes[:-1]))
        return tuple(zip(cols, self.multi_hot_sizes))

    def table_kind(self, k: int) -> str:
        """Embedding representation for table k: "dense" | "qr" | "md"
        (the reference's create_emb dispatch, dlrm_s_pytorch.py:239-286)."""
        n = self.table_sizes[k]
        if self.qr_flag and n > self.qr_threshold:
            return "qr"
        if self.md_flag and n > self.md_threshold:
            return "md"
        return "dense"

    def md_dims(self) -> Tuple[int, ...]:
        """Per-table embedding dims under the MD rule (md_solver output for
        md-eligible tables, embedding_dim for the rest)."""
        from deep_quantized_recommendation_model_dqrm_tpu_torch.models.tricks import (
            md_solver,
        )

        if not self.md_flag:
            return tuple(self.embedding_dim for _ in self.table_sizes)
        dims = md_solver(
            self.table_sizes,
            self.md_temperature,
            d0=self.embedding_dim,
            round_dim=self.md_round_dims,
        )
        return tuple(
            min(int(dims[k]), self.embedding_dim)
            if self.table_kind(k) == "md"
            else self.embedding_dim
            for k in range(len(self.table_sizes))
        )

    @property
    def num_tables(self) -> int:
        return len(self.table_sizes)

    @property
    def num_dense(self) -> int:
        return self.mlp_bot[0]

    @property
    def top_input_dim(self) -> int:
        """Input width of the top MLP (arch check dlrm_s_pytorch.py:1164-1181)."""
        return top_input_dim(self.num_tables, self.mlp_bot[-1], self.interaction, self.interact_itself)

    def validate_top(self) -> None:
        if self.mlp_top[0] != self.top_input_dim:
            raise ValueError(
                f"top MLP input {self.mlp_top[0]} != expected {self.top_input_dim}"
            )


def kaggle_config(quant: Optional[QuantConfig] = None) -> DLRMConfig:
    """Criteo Kaggle architecture (README.md run commands:
    --arch-sparse-feature-size=16 --arch-mlp-bot=13-512-256-64-16
    --arch-mlp-top=512-256-1), 26 tables with the Kaggle cardinalities."""
    table_sizes = (
        1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
        8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
        15, 286181, 105, 142572,
    )
    return DLRMConfig(
        table_sizes=table_sizes,
        embedding_dim=16,
        mlp_bot=(13, 512, 256, 64, 16),
        mlp_top=(367, 512, 256, 1),
        interaction="dot",
        quant=quant or QuantConfig(),
    )


def terabyte_config(quant: Optional[QuantConfig] = None) -> DLRMConfig:
    """Criteo Terabyte arch (README.md:57: d=64, bot 13-512-256-64,
    top 512-512-256-1, --max-ind-range=10000000)."""
    table_sizes = (
        9980333, 36084, 17217, 7378, 20134, 3, 7112, 1442, 61, 9758201,
        1333352, 313829, 10, 2208, 11156, 122, 4, 970, 14, 9994222,
        7267859, 9946608, 415421, 12420, 101, 36,
    )
    quant = quant or QuantConfig(scale_update_period=1000)
    return DLRMConfig(
        table_sizes=table_sizes,
        embedding_dim=64,
        mlp_bot=(13, 512, 256, 64),
        mlp_top=(415, 512, 512, 256, 1),
        interaction="dot",
        max_ind_range=10000000,
        quant=quant,
    )


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (dlrm_s_pytorch.py argparse run section)."""

    batch_size: int = 128  # `--mini-batch-size`
    test_batch_size: int = 16384  # `--test-mini-batch-size`
    nepochs: int = 1
    learning_rate: float = 0.01
    optimizer: str = "sgd"  # sgd | adagrad | rwsadagrad
    # LRPolicyScheduler (dlrm_s_pytorch.py:160-194)
    lr_num_warmup_steps: int = 0
    lr_decay_start_step: int = 0
    lr_num_decay_steps: int = 0
    print_freq: int = 1024
    print_wall_time: bool = False  # append HH:MM to the training print
    test_freq: int = -1
    seed: int = 123  # `--numpy-rand-seed`
    # DQRM gradient-communication compression (§2.3 of the survey):
    grad_quant_bits: int = 8  # INT8 gradient all-reduce
    error_compensation: bool = False  # MLP error feedback
    # Ranking-range mixed-bit embedding-gradient policy
    # (grad_precision_and_scale, sgd_…_parallel_comm.py:158-255): per
    # iteration, range-weighted sampling assigns each table skip / INT8 /
    # high-precision transport.
    ranking_range: bool = False
    ranking_frac_hi: float = 0.2
    ranking_frac_int8: float = 0.3
    # INT-compressed all-to-all of pooled embeddings in the hybrid step
    # (TPU-native extension; the reference ships activations at fp32,
    # hybrid_multi_gpu.py:866). 32 = uncompressed.
    a2a_quant_bits: int = 32
    weight_sync_period: int = 200  # periodic full-weight allreduce (comm_grad.py:1977)
    # QAT epoch schedule (comm_grad.py:1849-1872):
    # - pretrain_epochs: FP32 epochs before embedding quantization kicks in
    #   (`--pretrain_and_quantize`, epoch k==1 switch :1850-1853);
    # - quantize_mlp_from_epoch: epoch at which the MLP flips from FP32 to
    #   quantized (`--pretrain_and_quantize_lin` / change_lin_full_quantize,
    #   k==2 switch :1854-1856); -1 = from the start;
    # - shift_bit_width_at_epoch/to: lower the MLP bit width mid-training
    #   (`--linear_shift_down_bit_width` / change_bitw, k==3 switch
    #   :1870-1872); -1 = never.
    pretrain_epochs: int = 0
    quantize_mlp_from_epoch: int = -1
    shift_bit_width_at_epoch: int = -1
    shift_bit_width_to: int = 4
    # TPU-native optimization (no reference counterpart): tables with at most
    # this many rows apply their sparse update as an MXU one-hot dense grad
    # (ops/pallas/onehot_update.py) instead of the latency-bound serial
    # scatter (~34 ns/row). 0 disables. For fp32 tables identical up to fp32
    # summation order of duplicate ids; for bf16 tables the dense path
    # accumulates in fp32 and rounds ONCE on apply (the scatter path
    # accumulates in bf16) — a slightly more accurate, not identical, update.
    onehot_update_max_rows: int = 0
    # TPU-native optimization (no reference counterpart): tables with
    # onehot_update_max_rows < rows <= stream_update_max_rows apply their
    # sparse SGD update with the tile-streaming scatter-add kernel
    # (ops/pallas/stream_update.py): sequential full-table HBM traffic +
    # per-tile one-hot MXU matmuls instead of the ~34 ns/row serial
    # scatter. EXPERIMENTAL flag, measured-off by default: the kernel's
    # narrow-lane pipeline moves ~4.2 ns/table-row regardless of tile size
    # (~30x under the naive HBM cost model), so it wins only a narrow
    # ~50-150k-row band at B=8192 (~7%) — see stream_update.py's measured
    # status. The CLI auto rule resolves to 0 (off). 0 disables. Identical
    # up to fp32 summation order of duplicate ids (accumulates in fp32).
    stream_update_max_rows: int = 0
    # Gradient accumulation loss scale (`--mlperf-grad-accum-iter`,
    # dlrm_s_pytorch.py:1595-1601): the reference backwards each of the k
    # micro-batches WITHOUT zeroing grads, so the applied gradient is the
    # SUM of per-batch mean-loss grads. One step over the k-batch concat
    # yields the MEAN; multiplying the concat loss by k (= this scale)
    # reproduces the reference's sum-of-means trajectory exactly.
    loss_scale: float = 1.0

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
