"""Where the cycles of the int8 stem's and 3x3 conv's wgmma bodies go (K5
`int8_stem_pool`, K3 `int8_conv3x3`), from clock64 counters, on one NVIDIA
GPU.

    python tools/int8_conv_clocks.py [--batch 128]

Copies `icka_tpu_torch/` into `build/int8_conv_clocks/` (gitignored), adds
clock64 counters to the copy of `csrc/int8_conv_wgmma.cuh` (each consumer
warpgroup sums the cycles it spends waiting for a slot or a box, loading
A, waiting for its products and in its epilogue) and an entry point that
reads them, builds the copy and runs K5 at `--batch` and 16 images, and K3
at B=`--batch`, 14 x 14, C = F = 256 at each product size, each output
checked bit-equal to its plain version. Prints, per kernel, the mean over
the consumer warpgroups of each sum and its share of the warpgroup's
cycles. The counters change the code around them a little; the kernels'
times come from `tools/int8_conv_launches.py`, not from here. The package
itself is not modified; a source that no longer matches the patch points
fails here, loudly.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "int8_conv_clocks"

# (text in the source, what replaces it): the counters
PATCHES = (
    ("namespace icka_convw {\n",
     "namespace icka_convw {\n__device__ unsigned long long icka_clk[8192];\n"),
    # K5
    ("""    const unsigned zero2 = 0u;
    int acc[32 * NS];""", """    const unsigned zero2 = 0u;
    long long c_wait = 0, c_mma = 0, c_epi = 0, c_tiles = 0;
    const long long t_start = clock64();
    int acc[32 * NS];"""),
    ("""        mbar_wait(wbar(p.resident ? st >> 1 : 0), 0);
        mbar_wait(full(wg, slot), (q / p.slots) & 1);""", """        long long t0 = clock64();
        mbar_wait(wbar(p.resident ? st >> 1 : 0), 0);
        mbar_wait(full(wg, slot), (q / p.slots) & 1);
        c_wait += clock64() - t0;"""),
    ("""        wgmma_commit();
        wgmma_wait<1>();""", """        wgmma_commit();
        t0 = clock64();
        wgmma_wait<1>();
        c_mma += clock64() - t0;"""),
    ("""      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32 * NS; ++e) fence_operand(acc[e]);""",
     """      long long te = clock64();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32 * NS; ++e) fence_operand(acc[e]);
      c_mma += clock64() - te;
      te = clock64();
      ++c_tiles;"""),
    ("""                        v, ok);
      }
    }
  }
}""", """                        v, ok);
      }
      c_epi += clock64() - te;
    }
    if ((tid & 127) == 0) {
      unsigned long long* o = icka_clk + (blockIdx.x * 2 + wg) * 8;
      o[0] = clock64() - t_start; o[1] = c_wait; o[2] = c_mma;
      o[3] = c_epi; o[4] = c_tiles;
    }
  }
}"""),
    # K3
    ("""    int k = 0;
    auto box_wait = [&] {
      mbar_wait(box_full(k % p.boxes), (k / p.boxes) & 1);""",
     """    long long c_wait = 0, c_mma = 0, c_epi = 0, c_box = 0, c_lda = 0;
    const long long t_start = clock64();
    int k = 0;
    auto box_wait = [&] {
      const long long tb = clock64();
      mbar_wait(box_full(k % p.boxes), (k / p.boxes) & 1);
      c_box += clock64() - tb;"""),
    ("""              for (int c = 0; c < group_chunks(sgn); ++c) {
                const unsigned sb = wait_slot();
                load_a(fr);""", """              for (int c = 0; c < group_chunks(sgn); ++c) {
                long long t0 = clock64();
                const unsigned sb = wait_slot();
                c_wait += clock64() - t0;
                t0 = clock64();
                load_a(fr);
                c_lda += clock64() - t0;"""),
    ("""                wgmma_commit();
                wgmma_wait<0>();
#pragma unroll
                for (int i = 0; i < MBW; ++i)""", """                wgmma_commit();
                t0 = clock64();
                wgmma_wait<0>();
                c_mma += clock64() - t0;
#pragma unroll
                for (int i = 0; i < MBW; ++i)"""),
    ("""            const unsigned stg = stage + warp * 16 * kStagePitch * 4;""",
     """            const long long te = clock64();
            const unsigned stg = stage + warp * 16 * kStagePitch * 4;"""),
    ("""                        ok && c0 + 4 * v < p.F);
                }
              }
            }
          }
        });
      }
    }
  }
}""", """                        ok && c0 + 4 * v < p.F);
                }
              }
            }
            c_epi += clock64() - te;
          }
        });
      }
    }
    if ((tid & 127) == 0) {
      unsigned long long* o = icka_clk + (blockIdx.x * 2 + wg) * 8;
      o[0] = clock64() - t_start; o[1] = c_wait; o[2] = c_mma;
      o[3] = c_epi; o[4] = c_box; o[5] = c_lda; o[6] = k;
    }
  }
}"""),
)

READER = '''
extern "C" int icka_read_clk(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, icka_convw::icka_clk, n * 8);
}
extern "C" int icka_zero_clk() {
  static unsigned long long z[8192] = {};
  return (int)cudaMemcpyToSymbol(icka_convw::icka_clk, z, sizeof(z));
}
'''


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "icka_tpu_torch", COPY / "icka_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", COPY / "chip_smoke.py")
    csrc = COPY / "icka_tpu_torch" / "kernels" / "csrc"
    header = csrc / "int8_conv_wgmma.cuh"
    text = header.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"int8_conv_clocks: the source no longer has "
                             f"this patch point once:\n{old}")
        text = text.replace(old, new)
    header.write_text(text)
    entry = csrc / "int8_conv.cu"
    entry.write_text(entry.read_text() + READER)


def measure(batch: int) -> None:
    """Runs inside the copy (its directory first on sys.path)."""
    import torch

    import chip_smoke as cs
    from icka_tpu_torch.kernels import conv as kc

    lib = kc._lib()
    lib.icka_read_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def clocks(what, fn, plain, names, grid):
        cs.check_equal(what, fn(), plain(), {}, what)
        torch.cuda.synchronize()
        lib.icka_zero_clk()
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8192)()
        lib.icka_read_clk(ctypes.addressof(buf), 8192)
        rows = [[buf[(c * 2 + wg) * 8 + k] for k in range(8)]
                for c in range(grid) for wg in range(2)]
        rows = [r for r in rows if r[0]]
        total = sum(r[0] for r in rows) / len(rows)
        parts = ", ".join(
            f"{name} {sum(r[i + 1] for r in rows) / len(rows):.0f} "
            f"({sum(r[i + 1] for r in rows) / len(rows) / total:.2f})"
            for i, name in enumerate(names))
        print(f"{what}: {len(rows)} consumer warpgroups, {total:.0f} "
              f"cycles each (max {max(r[0] for r in rows)}); {parts}")

    with torch.inference_mode():
        for B in sorted({batch, 16}, reverse=True):
            a = cs.stem_inputs(gen, B)
            t = kc.kmajor_tiles(a[1])
            g = kc.stem_geometry(B, 56, *a[1].shape)
            clocks(f"int8_stem_pool B={B} ({g['ntiles']} tiles, "
                   f"{g['grid']} CTAs)",
                   lambda: kc._int8_stem_pool_tiled(t, *a),
                   lambda: kc.stem_pool_reference(*a),
                   ("wait for a slot", "products", "epilogue", "tiles"),
                   g["grid"])
        c = cs.conv3x3_inputs(gen, batch, 14, 256, 256)
        a = (c["x_pad"], c["w_q"], c["scale"], c["bias"])
        for rows in (128, 256, 64):
            g = kc._conv3_geometry(batch, 14, 14, 256, 256, 132, rows)
            clocks(f"int8_conv3x3 B={batch} 14x14 C=F=256, tiles "
                   f"{g['TR']}x{g['TC']} ({g['BM']} rows), passes of "
                   f"{g['np']}, {g['nitems']} items",
                   lambda: kc._conv3x3_launch(*a, None, True, None,
                                              torch.bfloat16, g),
                   lambda: kc.conv3x3_reference(*a),
                   ("wait for a slot", "products", "epilogue",
                    "wait for a box", "load A", "box rounds"), g["grid"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--in-copy", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.in_copy:
        sys.path.insert(0, str(COPY))
        measure(args.batch)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("int8_conv_clocks: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    make_copy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return subprocess.run([sys.executable, __file__, "--in-copy",
                           "--batch", str(args.batch)], cwd=COPY).returncode


if __name__ == "__main__":
    sys.exit(main())
