"""Where the mLSTM's bf16 recurrent kernel spends a chunk, on the card.

    python3 scripts/mlstm_phases.py

Builds a copy of ``kernels/mlstm/csrc/mlstm.cu`` with ``clock64()`` stamps
added at the phase boundaries of ``recurrent_tc`` (block (0, 0), thread 0
of each warpgroup, chunks 4..7), runs the 2048-token prefill shape of
``chip_smoke.py``'s timed check (B=1, H=4, dh=1024, L=64, bf16, with a
start state) through the port's wrapper, and prints the median cycles of
each phase of a tile and of a chunk.  The card has no profiler that sees
inside a kernel (ncu does not run there), so the stamps are the way in;
they cost a few cycles each and change the register allocation a little.
The stamps' anchors are lines of the kernel's source: the script stops if
one is missing.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TILE_PHASES = ["wait for the tile, barrier", "issue the next tile's copies",
               "q C issued, f32 sums", "q C done, barrier", "k o w pair, n, barrier",
               "state update done"]
CHUNK_PHASES = ["wait for gates and v", "v^T, prefetch, barrier", "the tiles",
                "partials, barrier"]


def instrumented(src: str) -> str:
    def stamp(where, k):
        return (f"\n{' ' * where}if (blockIdx.x == 0 && blockIdx.y == 0 && wt == 0 && c >= 4 "
                f"&& c < 8) g_dbg[{k}] = clock64();\n")

    tile = lambda k: stamp(6, f"((c - 4) * NWG + wg) * 64 + j * 8 + {k}")  # noqa: E731
    chunk = lambda k: stamp(4, f"1024 + ((c - 4) * NWG + wg) * 8 + {k}")  # noqa: E731
    edits = [  # (anchor, text, after?)
        ("      if (j >= my_tiles) continue;  // warpgroup-uniform\n"
         "      const int e0 = (wg * MT + j) * 64;", tile(0), True),
        ("      wg_bar(wg);  // tile u landed and C^T is visible; tile u - 1's products are "
         "done", tile(1), True),
        ("      if (u + 1 < n_units) load(u + 1);\n      sm90::cp_async_commit();", tile(2), True),
        ("      sm90::wgmma_wait0();\n      sm90::fence_regs(qc);\n      wg_bar(wg);  // q and k "
         "are read", tile(3), False),
        ("      wg_bar(wg);  // q and k are read: q's tile takes the lo half of k o w", tile(4),
         True),
        ("\n      // C = decay C + (k o w)^T v (M = e, N = f, K = t; A M-major through", tile(5),
         False),
        ("      sm90::wgmma_wait0();\n      sm90::fence_regs(C[j]);", tile(6), True),
        ("    const float* gv = reinterpret_cast<const float*>(sm + Lay::kGates", chunk(0),
         False),
        ("    __syncthreads();  // the last chunk's h is written; this chunk's gates and v "
         "landed", chunk(1), True),
        ("    sm90::fence_proxy_async();\n    __syncthreads();\n"
         "    const float decay = inter[Lc - 1];\n", chunk(2), True),
        ("    // the partial sums of q C and q n to shared memory", chunk(3), False),
        ("    sm90::cp_async_wait<0>();  // this chunk's att (warpgroup 0 reads it next)\n"
         "    __syncthreads();", chunk(4), True),
        ("namespace {\n\nusing bf16", "__device__ unsigned long long g_dbg[2048];\n"
         "extern \"C\" int read_dbg(void* dst) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, g_dbg, sizeof(g_dbg));\n}\n", False),
    ]
    for anchor, text, after in edits:
        if src.count(anchor) != 1:
            sys.exit(f"mlstm_phases: anchor not found once in mlstm.cu: {anchor[:60]!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)
    return src


def main():
    if not torch.cuda.is_available():
        sys.exit("mlstm_phases: torch sees no CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm import ops
    out = Path(tempfile.mkdtemp(prefix="mlstm_phases_"))
    cu = out / "mlstm.cu"
    cu.write_text(instrumented(_build.sources()["mlstm"].read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.INCLUDE_DIR),
                    "-o", str(out / "libmlstm.so"), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "libmlstm.so"))
    fn = lib.mlstm
    fn.argtypes, fn.restype = ops._ARGTYPES, ctypes.c_int
    _build._libs[("mlstm", "mlstm")] = fn               # the wrapper calls this build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H, dh, L = 1, 2048, 4, 1024, 64
    q = (torch.randn(B, S, H, dh, generator=gen, device=dev) / dh ** 0.5).to(torch.bfloat16)
    k, v = (torch.randn(B, S, H, dh, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    log_i = torch.randn(B, S, H, generator=gen, device=dev) * 2
    log_f = torch.nn.functional.logsigmoid(torch.randn(B, S, H, generator=gen, device=dev) + 4)
    state = (torch.randn(B, H, dh, dh, generator=gen, device=dev) * 0.1,
             torch.randn(B, H, dh, generator=gen, device=dev) * 0.1,
             torch.randn(B, H, generator=gen, device=dev))
    for _ in range(3):
        ops.mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk=L)
    torch.cuda.synchronize()
    buf = np.zeros(2048, dtype=np.uint64)
    if lib.read_dbg(ctypes.c_void_p(buf.ctypes.data)):
        sys.exit("mlstm_phases: reading the stamps failed")
    nwg = ops.warpgroups(dh)[0]
    tiles = buf[:1024].reshape(4, nwg, 64)[:, :, :32].reshape(4, nwg, 4, 8).astype(np.int64)
    d = np.diff(tiles[..., :7], axis=-1)                   # (chunk, warpgroup, tile, phase)
    print(torch.cuda.get_device_name(0), "- cycles, median over chunks 4..7, tiles, warpgroups")
    for i, name in enumerate(TILE_PHASES):
        print(f"  tile  {name:32s} {int(np.median(d[..., i])):7d}")
    print(f"  tile  {'total':32s} {int(np.median(tiles[..., 6] - tiles[..., 0])):7d}")
    chunks = buf[1024:1024 + 4 * nwg * 8].reshape(4, nwg, 8).astype(np.int64)
    dc = np.diff(chunks[..., :5], axis=-1)
    for i, name in enumerate(CHUNK_PHASES):
        print(f"  chunk {name:32s} {int(np.median(dc[..., i])):7d}")
    print(f"  chunk {'period (warpgroup 0)':32s} "
          f"{int(np.median(np.diff(chunks[:, 0, 0]))):7d}")


if __name__ == "__main__":
    main()
