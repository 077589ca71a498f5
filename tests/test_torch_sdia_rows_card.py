"""B14 over a row-major X and Y on the card: ``sdia_sym_rows_kernel``
(through ``sdia_df.sdia_sym_rows_df_mm``) against its plain twin on the
card, with HPCG-256's 14 lower offsets (up to 65,793) over 200,003 rows,
not a multiple of a CTA's 128, at B = 8 (one launch) and 16 (two). Each Y
is allocated where a NaN-filled block was just freed, so a row the kernel
left unwritten would read NaN: every element of Y is shown written.

Runs only where there is a CUDA card (``pytest -m card``); the CPU tests of
the same function are in ``tests/test_torch_sdia_rows.py``. Tolerance:
1e-13 of |A| |X| (the same products as the twin's, summed with FMA).
"""

import pytest
import torch

from cfs_spmv_tpu_torch.ops import sdia_df as sdf

#: HPCG's 14 lower offsets on a 256^3 grid
OFFSETS = sorted({dz * 65536 + dy * 256 + dx for dz in (0, 1)
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                  if dz * 65536 + dy * 256 + dx >= 0})
ROWS = 200_003


@pytest.fixture
def card():
    """A CUDA card, else the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("B", [8, 16])
def test_rows_kernel_matches_twin_on_every_row(card, B):
    assert max(OFFSETS) == 65_793 and ROWS % 128
    g = torch.Generator(device=card).manual_seed(B)
    R = -(-ROWS // 1024)
    vals = torch.rand((R, len(OFFSETS), 8, 128), generator=g,
                      dtype=torch.float64, device=card) - 0.5
    offs = torch.tensor(OFFSETS, dtype=torch.int32, device=card)
    X = torch.rand((ROWS, B), generator=g, dtype=torch.float64,
                   device=card) - 0.5
    before = sdf.sdia_sym_rows_df_mm.launches
    poison = torch.full((ROWS, B), float("nan"), dtype=torch.float64,
                        device=card)
    del poison
    Y = sdf.sdia_sym_rows_df_mm(vals, X, offs)
    torch.cuda.synchronize()
    assert sdf.sdia_sym_rows_df_mm.launches - before == -(-B // 8)
    assert Y.shape == (ROWS, B) and Y.is_contiguous()
    assert torch.isfinite(Y).all()
    want = sdf.sdia_sym_rows_plain(vals, X, offs)
    scale = sdf.sdia_sym_rows_plain(vals.abs(), X.abs(), offs)
    err = ((Y - want).abs() / scale.clamp_min(1e-300)).max().item()
    assert err < 1e-13
