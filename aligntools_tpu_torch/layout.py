"""Packed pointer codes shared by the pointer fill and the traceback walk.

The JAX package's layout (``aligntools_tpu/engine/scan.py:97-101``,
``aligntools_tpu/ops/pallas_ptr.py:62-65`` and ``:95-102``), kept here
because those modules import jax. One cell's pointers:

  rpb 1 (a byte a cell; fit+jump needs it)
    bits 0-2  pM, the state that fed M: LOW/MID/UPP/JUMP/HOME, 7 unset
    bit  3    pL: L came from M (gap open), else from L (extend)
    bit  4    pU: U came from U (extend), else from M (open)
    bit  5    pJ: J came from J (carry), else from M (entry)
  rpb 2 (a nibble a cell; two DP rows a byte, row 2k in the low bits)
    bits 0-1  pM; code 3 is HOME for local, unset for global and fit
    bit  2    pL
    bit  3    pU
  overlap (2 bits a cell at rpb 4; the same codes at rpb 1 and 2)
    LEFT/DIAG/RIGHT = 0/1/2, 3 unset

``rpb`` DP rows share a byte, row ``rpb*k + r`` at bit ``r * 8 // rpb``.
"""

PK_LOW, PK_MID, PK_UPP, PK_JUMP, PK_HOME, PK_UNSET = 0, 1, 2, 3, 4, 7
PK_L_IS_MID = 1 << 3
PK_U_IS_UPP = 1 << 4
PK_J_IS_JUMP = 1 << 5

# rpb > 1
PK2_CODE3 = 3  # HOME for local, unset for global and fit
PK2_L_IS_MID = 1 << 2
PK2_U_IS_UPP = 1 << 3

OV_LEFT, OV_DIAG, OV_RIGHT, OV_UNSET = 0, 1, 2, 3


def rows_per_byte(mode: str, use_jump: bool, m_pad: int) -> int:
    """The densest packing the mode allows at this m_pad (the JAX
    package's rule, ``batch.py:754-761``)."""
    if mode == "fit" and use_jump:
        return 1
    if mode == "overlap" and m_pad % 32 == 0:
        return 4
    if m_pad % 16 == 0:
        return 2
    return 1
