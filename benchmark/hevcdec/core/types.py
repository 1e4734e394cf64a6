"""Core enums and type aliases for the HEVC codec.

Parity: reference TypeDef.h (slice types, PartSize, chroma formats,
prediction modes) — re-expressed as Python IntEnums. Pixel math on device
uses int32 lanes (TPU has no native int16 vector math benefit for us);
host-side frame stores use numpy int16 for 8..12-bit content, matching the
reference's ``Pel = Short`` (TypeDef.h:698-717).
"""
from __future__ import annotations

import enum

import numpy as np

# Host dtypes (device kernels up-cast to int32).
PEL_DTYPE = np.int16        # sample values (8..16 bit content)
COEFF_DTYPE = np.int32      # transform coefficients
DIST_DTYPE = np.int64       # distortion accumulators


class SliceType(enum.IntEnum):
    # Values match the HEVC spec slice_type syntax element.
    B = 0
    P = 1
    I = 2


class PredMode(enum.IntEnum):
    INTER = 0
    INTRA = 1


class PartSize(enum.IntEnum):
    """PU partitioning of a CU. Parity: TypeDef.h enum PartSize."""
    SIZE_2Nx2N = 0
    SIZE_2NxN = 1
    SIZE_Nx2N = 2
    SIZE_NxN = 3
    SIZE_2NxnU = 4
    SIZE_2NxnD = 5
    SIZE_nLx2N = 6
    SIZE_nRx2N = 7


class ChromaFormat(enum.IntEnum):
    # Values match chroma_format_idc.
    C400 = 0
    C420 = 1
    C422 = 2
    C444 = 3


class Component(enum.IntEnum):
    Y = 0
    Cb = 1
    Cr = 2


class NalUnitType(enum.IntEnum):
    """HEVC NAL unit types (spec Table 7-1). Subset we emit/parse."""
    TRAIL_N = 0
    TRAIL_R = 1
    TSA_N = 2
    TSA_R = 3
    STSA_N = 4
    STSA_R = 5
    RADL_N = 6
    RADL_R = 7
    RASL_N = 8
    RASL_R = 9
    BLA_W_LP = 16
    BLA_W_RADL = 17
    BLA_N_LP = 18
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    VPS_NUT = 32
    SPS_NUT = 33
    PPS_NUT = 34
    AUD_NUT = 35
    EOS_NUT = 36
    EOB_NUT = 37
    FD_NUT = 38
    PREFIX_SEI_NUT = 39
    SUFFIX_SEI_NUT = 40

    @property
    def is_irap(self) -> bool:
        return 16 <= self.value <= 23

    @property
    def is_idr(self) -> bool:
        return self in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP)


class IntraMode:
    """Intra prediction mode indices (spec 8.4.2). 0=planar, 1=DC, 2..34 angular."""
    PLANAR = 0
    DC = 1
    ANGULAR_FIRST = 2
    HORIZONTAL = 10
    VERTICAL = 26
    ANGULAR_LAST = 34
    DM_CHROMA = 36  # chroma "derived mode" marker
    NUM_LUMA_MODES = 35


class ScanOrder(enum.IntEnum):
    # Values match scanIdx derivation (spec 7.4.9.11).
    DIAG = 0
    HOR = 1
    VER = 2


def chroma_shift_x(fmt: ChromaFormat) -> int:
    return 1 if fmt in (ChromaFormat.C420, ChromaFormat.C422) else 0


def chroma_shift_y(fmt: ChromaFormat) -> int:
    return 1 if fmt == ChromaFormat.C420 else 0
