"""The kernel-variant tool's source edits: each named edit of K3, K1 and K5
applies to the current CUDA sources (an edit whose text is gone raises, so a
kernel change cannot leave a variant silently equal to the kernel)."""

import pytest

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.tools import kernel_variants as kv

SOURCES = {"k3": ("quant_matmul.cu", kv.EDITS), "k1": ("onehot_update.cu", kv.K1_EDITS),
           "k5": ("stream_update.cu", kv.K5_EDITS)}


@pytest.mark.parametrize("kernel,name", [(k, n) for k, (_, edits) in SOURCES.items() for n in edits])
def test_variant_edit_applies(kernel, name):
    src_name, edits = SOURCES[kernel]
    src = (_build.CSRC_DIR / src_name).read_text()
    edited = edits[name](src)
    assert edited != src


def test_stale_edit_raises():
    with pytest.raises(RuntimeError):
        kv._sub(("no such text", ""))("a kernel source")
    # a two-part edit raises when only its second text is gone
    with pytest.raises(RuntimeError):
        kv._sub(("a", "b"), ("gone", ""))("a kernel source")
