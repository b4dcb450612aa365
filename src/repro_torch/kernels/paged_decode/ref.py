"""Plain PyTorch version of the paged decode kernel (port of
``repro/kernels/decode_attention/ref.py`` ``paged_decode_attention_ref``):
gather the row's pages into a dense view, then the dense decode's plain
version in float32."""
from __future__ import annotations

from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def gather_dense(arena, page_table):
    """(P, BLOCK, Hkv, D) arena -> (B, Hkv, n_pg * BLOCK, D) per-row view."""
    B, n_pg = page_table.shape
    g = arena[page_table.reshape(-1).long()]
    return g.reshape(B, n_pg * arena.shape[1], *arena.shape[2:]).transpose(1, 2)


def paged_decode_attention_ref(q, k_arena, v_arena, page_table, lengths, *,
                               window=None, softcap=None, scale=None):
    """q: (B, H, D); arenas: (P, BLOCK, Hkv, D); page_table: (B, n_pg);
    lengths: (B,) valid tokens (0 = dead row, output discarded)."""
    return decode_attention_ref(
        q, gather_dense(k_arena, page_table).transpose(1, 2),
        gather_dense(v_arena, page_table).transpose(1, 2), lengths,
        window=window, softcap=softcap, scale=scale)
