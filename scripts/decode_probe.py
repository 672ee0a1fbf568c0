"""Where a token's time goes inside K9's persistent kernel, on one CUDA card.

    python3 scripts/decode_probe.py [probe|nowork]

Copies ``videomamba_tpu_torch/csrc/decode_step.cu`` and its headers to
``build/decode_probe/``, adds global-timer stamps that thread 0 of block 0
(and the barrier's thread) writes at each step of a phase, builds K9 alone
(fp32 weights) with nvcc and runs Base widths (depth 24, E 768, d_inner
1536, N 16, R 48; seeded weights) at B = 1 and 80. Prints the event ms a
token and, for one token, the time between each pair of consecutive
stamps, summed and averaged over the token. Stamp ids: 1 the barrier's
arrival, 2 its release; 10-13 the start of phases in, x_proj, state, out;
20 an activation tile's staging begins, 21 its rows have landed, 23 it is
normed and rounded; 4 the phase's weights have landed; 5 in_proj's sums
are done.

Variant ``nowork`` skips every phase's work, leaving the barriers and the
weight copies. Every source patch must apply, or the
script stops. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import collections
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "videomamba_tpu_torch" / "csrc"
BUILD = ROOT / "build" / "decode_probe"

STAMP = """namespace vmt {
namespace dec {
__device__ unsigned long long* g_probe;
__device__ int g_slot;
__device__ __forceinline__ void stamp(int id) {
  if (!g_probe || blockIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int s = g_slot++;
  if (s < 60000) {
    g_probe[2 * s] = id;
    g_probe[2 * s + 1] = t;
  }
}"""

HEADER_PATCHES = [
    ("namespace vmt {\nnamespace dec {", STAMP),
    ("""  } else if (threadIdx.x == kSyncThread) {
    asm volatile("red.release""", """  } else if (threadIdx.x == kSyncThread) {
    stamp(1);
    asm volatile("red.release"""),
    ("""    } while ((int)(v - target) < 0);
  }""", """    } while ((int)(v - target) < 0);
    stamp(2);
  }"""),
    ("""  __syncthreads();  // the last users of act are done""",
     """  __syncthreads();  // the last users of act are done
  if (threadIdx.x == 0) stamp(20);"""),
    ("""  if (norm) {
    const float inv_k = 1.f / (float)kn;""", """  if (threadIdx.x == 0) stamp(21);
  if (norm) {
    const float inv_k = 1.f / (float)kn;"""),
    ("""      *p = v;
    }
  }
  __syncthreads();
}""", """      *p = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) stamp(23);
}"""),
]

SOURCE_PATCHES = [
    ('#include "decode_persist.cuh"', '#include "probe_persist.cuh"'),
    ("""  dec::cp_wait_prev();
  __syncthreads();
  blk.waited = true;""", """  dec::cp_wait_prev();
  __syncthreads();
  blk.waited = true;
  if (threadIdx.x == 0) dec::stamp(4);"""),
    ("""                        pl.in_mma, blk.red, blk.res);
      for (int i""", """                        pl.in_mma, blk.red, blk.res);
      if (threadIdx.x == 0) dec::stamp(5);
      for (int i"""),
    ("""    const int k = gp / kPhases, ph = gp % kPhases;
    TW* wsm""", """    if (threadIdx.x == 0) dec::stamp(10 + gp % kPhases);
    const int k = gp / kPhases, ph = gp % kPhases;
    TW* wsm"""),
    # K9 fp32 only: the other instantiations are not built
    ("""  err = dims[0] ? k9_bt<bf16>(io, pl, dims[10], device, s)
                : k9_bt<float>(io, pl, dims[10], device, s);""",
     """  err = k9_bt<float>(io, pl, dims[10], device, s);"""),
    ("""  err = dims[0] ? k15_bt<bf16>(io, pl, dims[11], device, s)
                : k15_bt<float>(io, pl, dims[11], device, s);""",
     """  err = cudaErrorInvalidValue;"""),
]

NOWORK = [  # the phases' bodies off; the weights still waited for before each barrier
    ("    if (ph == 0) {\n      in_phase<TW, BT>(blk", "    if (ph == 9) {\n      in_phase<TW, BT>(blk"),
    ("    } else if (ph == 1) {\n      // Each tile", "    } else if (ph == 9) {\n      // Each tile"),
    ("    } else if (ph == 2) {\n      if (nch > 0) {\n        // Per tile",
     "    } else if (ph == 9) {\n      if (nch > 0) {\n        // Per tile"),
    ("""    } else {
      const bool last = k == io.K - 1;
      out_phase<TW, BT>(blk, pl, wsm, (const TW*)io.out_w + (long long)k * E * Di, out_lo,
                        out_hi, B, E, Di, y,""", """    } else if (ph == 9) {
      const bool last = k == io.K - 1;
      out_phase<TW, BT>(blk, pl, wsm, (const TW*)io.out_w + (long long)k * E * Di, out_lo,
                        out_hi, B, E, Di, y,"""),
]


def patched(text: str, patches, what: str) -> str:
    for old, new in patches:
        if text.count(old) < 1:
            raise SystemExit(f"decode_probe: a {what} patch no longer applies: {old[:60]!r}")
        text = text.replace(old, new, 1 if old.startswith("namespace") else -1)
    return text


def build(variant: str) -> Path:
    BUILD.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, BUILD / f.name)
    hdr = patched((CSRC / "decode_persist.cuh").read_text(), HEADER_PATCHES, "header")
    src = patched((CSRC / "decode_step.cu").read_text(), SOURCE_PATCHES
                  + (NOWORK if variant == "nowork" else []), "source")
    src += """
extern "C" int vmt_probe_set(unsigned long long* p) {
  int zero = 0;
  cudaMemcpyToSymbol(vmt::dec::g_probe, &p, sizeof(p));
  return (int)cudaMemcpyToSymbol(vmt::dec::g_slot, &zero, sizeof(int));
}
"""
    (BUILD / "probe_persist.cuh").write_text(hdr)
    (BUILD / f"probe_{variant}.cu").write_text(src)
    lib = BUILD / f"libprobe_{variant}.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-w", "-o", str(lib),
                    str(BUILD / f"probe_{variant}.cu")], check=True)
    return lib


def main() -> int:
    variant = sys.argv[1] if len(sys.argv) > 1 else "probe"
    if variant not in ("probe", "nowork") or not torch.cuda.is_available():
        print("decode_probe: needs a CUDA card; variants probe, nowork", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from videomamba_tpu_torch.ops.kernels import _build
    from videomamba_tpu_torch.ops.kernels import decode_step as k9

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no card line")
    lib = ctypes.CDLL(str(build(variant)))
    for name in ("vmt_decode_stack", "vmt_decode_stack_m2"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.vmt_probe_set.argtypes = (ctypes.c_void_p,)
    _build.library = lambda: lib  # the probe's K9 in place of the package's library
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(0)
    depth, e, di, n, r, w = 24, 768, 1536, 16, 48, 4

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dev)

    for bsz in (1, 80):
        kw = dict(norm_w=1 + rn(depth, e, scale=0.1), norm_b=None,
                  in_proj_w=rn(depth, 2 * di, e, scale=e ** -0.5),
                  out_proj_w=rn(depth, e, di, scale=di ** -0.5), conv_w=rn(depth, di, w, scale=0.5),
                  conv_b=rn(depth, di, scale=0.1),
                  x_proj_w=rn(depth, r + 2 * n, di, scale=di ** -0.5),
                  dt_proj_w=rn(depth, di, r, scale=r ** -0.5),
                  dt_bias=torch.linspace(-4.0, -1.0, di, device=dev).expand(depth, di).contiguous(),
                  A=-torch.exp(rn(depth, di, n, scale=0.3)), D=rn(depth, di),
                  conv_states=rn(depth, bsz, di, w), ssm_states=rn(depth, bsz, di, n, scale=0.3))
        tok = rn(bsz, e)
        launch = k9.prepare_decode_stack(bsz, dev, **kw)
        for _ in range(3):
            launch.run(tok)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch.run(tok)
        stop.record()
        torch.cuda.synchronize()
        print(f"{variant} B={bsz}: {start.elapsed_time(stop) / 20:.4f} ms a token (event)")
        stamps = torch.zeros(120000, dtype=torch.int64, device=dev)
        lib.vmt_probe_set(ctypes.c_void_p(stamps.data_ptr()))
        launch.run(tok)
        torch.cuda.synchronize()
        lib.vmt_probe_set(ctypes.c_void_p(0))
        pairs = stamps.view(-1, 2).cpu()
        pairs = pairs[pairs[:, 1] > 0]
        ids, ts = pairs[:, 0].tolist(), pairs[:, 1].tolist()
        spans = collections.defaultdict(lambda: [0, 0.0])
        for i in range(1, len(ids)):
            key = f"{ids[i - 1]}->{ids[i]}"
            spans[key][0] += 1
            spans[key][1] += (ts[i] - ts[i - 1]) / 1e3
        print(f"  one token, block 0: {(ts[-1] - ts[0]) / 1e3:.1f} us")
        for key, (count, us) in sorted(spans.items(), key=lambda kv: -kv[1][1])[:20]:
            print(f"  {key:8s} n={count:4d} total {us:8.1f} us, mean {us / count:6.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
