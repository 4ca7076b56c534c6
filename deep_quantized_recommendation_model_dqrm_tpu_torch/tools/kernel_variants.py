"""Where kernel K3's time goes: variants of csrc/quant_matmul.cu on the card.

Each variant is the package's source with one named edit, built with the
package's nvcc flags into a library of its own and timed by torch.profiler
device time on the seven Kaggle serving layers at B = 16384 (random
activations and weights from a seed), in turns: A, B, ..., B, A. Run from
the repository root on a machine with a card and the CUDA toolkit:

    python3 -m deep_quantized_recommendation_model_dqrm_tpu_torch.tools.kernel_variants [name ...]

Variants (`as_is` always runs, first and last):

- `no_wgmma`: the three tensor-core passes dropped (wrong results): the time
  of everything else;
- `no_x_loads`: no copies of x into the ring (wrong results);
- `fill_only`: every block returns after converting its weight tile;
- `fill_and_epilogue`: the main loop dropped (wrong results);
- `ring3`, `ring6`: a ring of 3 or 6 x fragments per thread instead of 4
  (6 leaves room for K <= 512 only).

Prints one JSON line per variant and turn, then `torch.addmm`'s time on
the dequantized weights. Variants that drop work print large errors.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import _build
from deep_quantized_recommendation_model_dqrm_tpu_torch.ops.cuda import quant_matmul as qm

SOURCE = _build.CSRC_DIR / "quant_matmul.cu"
OUT_DIR = _build.BUILD_DIR / "variants"
LAYERS = [(13, 512), (512, 256), (256, 64), (64, 16), (367, 512), (512, 256), (256, 1)]
BATCH = 16384

_PASSES = """      wgmma_bf16<BN>(acc, a_hi, desc);
      wgmma_bf16<BN>(acc, a_mid, desc);
      wgmma_bf16<BN>(acc, a_lo, desc);
"""
_FENCE = """  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  __syncthreads();
"""
_STAGES = "constexpr int kMaxKp = 640;\nconstexpr int kStages = 4;"
_MAIN_START = "#pragma unroll\n    for (int st = 0; st < kStages - 1; ++st) {"
_MAIN_END = "    // acc[4i + 2h + e] holds row"


def _drop_main_loop(src: str) -> str:
    return src[: src.index(_MAIN_START)] + src[src.index(_MAIN_END):]


EDITS = {
    "no_wgmma": lambda s: s.replace(_PASSES, ""),
    "no_x_loads": lambda s: s.replace(
        "      if (s + kStages - 1 < steps) issue(s + kStages - 1);", ""
    ).replace("      if (st < steps) issue(st);", ""),
    "fill_only": lambda s: s.replace(_FENCE, _FENCE + "  if (relu != 7) return;\n"),
    "fill_and_epilogue": _drop_main_loop,
    "ring3": lambda s: s.replace(_STAGES, "constexpr int kMaxKp = 640;\nconstexpr int kStages = 3;"),
    "ring6": lambda s: s.replace(_STAGES, "constexpr int kMaxKp = 512;\nconstexpr int kStages = 6;"),
}


def build(names):
    """{name: loaded library}, `as_is` being the package's own."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        edited = EDITS[name](src)
        if edited == src:
            raise RuntimeError(f"variant {name}: its edit no longer matches {SOURCE.name}")
        cu = OUT_DIR / f"quant_matmul_{name}.cu"
        cu.write_text(edited)
        so = OUT_DIR / f"libquant_matmul_{name}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"as_is": _build.load("quant_matmul", qm._SIGNATURES)}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.dqrm_int8_linear.argtypes = qm._SIGNATURES["dqrm_int8_linear"]
        lib.dqrm_int8_linear.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, n: int = 10) -> float:
    """Device time of one fn() call in ms: its kernels' durations summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no usable CUDA card", file=sys.stderr)
        return 1
    names = list(argv)
    unknown = [n for n in names if n not in EDITS]
    if unknown:
        print(f"unknown variants {unknown}; known: {sorted(EDITS)}", file=sys.stderr)
        return 2
    libs = build(names)
    rng = np.random.RandomState(0)
    work = []
    for K, N in LAYERS:
        w = torch.from_numpy(rng.normal(0, np.sqrt(2 / (K + N)), size=(N, K)).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.normal(0, 0.1, size=(N,)).astype(np.float32)).cuda()
        x = torch.from_numpy(rng.uniform(0, 2, size=(BATCH, K)).astype(np.float32)).cuda()
        work.append((x, qm.quantize_linear_weights(w, b, 8), torch.empty((BATCH, N), device="cuda")))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, x, qw, out):
        err = lib.dqrm_int8_linear(x.data_ptr(), qw.w_int.data_ptr(), qw.scale.data_ptr(),
                                   qw.bias.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                                   qw.w_int.shape[0], 1, stream)
        _build.check(err, "int8_linear variant")

    order = ["as_is"] + names + names[::-1] + ["as_is"]
    for name in order:
        lib = libs[name]
        errs = []
        for x, qw, out in work:
            launch(lib, x, qw, out)
            want = qm.int8_linear_xla(x, qw, relu=True)
            errs.append((out - want).abs().max().item() / max(1.0, want.abs().max().item()))
        layers = [device_ms(lambda: launch(lib, *a)) for a in work]
        print(json.dumps({"variant": name, "device_ms": sum(layers), "per_layer_ms": layers,
                          "max_err_over_max": max(errs)}), flush=True)
    deq = [(x, qw.bias, (qw.w_int.float() * qw.scale[:, None]).T) for x, qw, _ in work]
    print(json.dumps({"addmm_device_ms": device_ms(lambda: [torch.addmm(b, x, w) for x, b, w in deq]),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
