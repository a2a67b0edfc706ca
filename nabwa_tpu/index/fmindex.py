"""FM-index containers: host-side load of the eight reference-format files
and device placement as flat arrays in device memory.

Device layout decision: we keep the reference's interleaved checkpoint
layout (bwt.h:61-68) as a flat uint32 vector — one 12-word block per 128
bases means an occ4 query touches 48 contiguous bytes, the unit both the
XLA gathers and the CUDA kernel's loads fetch.  The index is replicated per
device (≤4 Gbp references, bwtindex.c:103-105).
"""

import dataclasses
from pathlib import Path

import numpy as np

from . import formats
from . import pack as packmod
from ..constants import SA_INTERVAL


@dataclasses.dataclass
class FmIndex:
    """One search direction (forward or reverse BWT) as host numpy arrays."""

    primary: int
    l2: np.ndarray        # [5] uint32 cumulative counts
    bwt: np.ndarray       # interleaved uint32 words
    sa: np.ndarray        # sampled SA, sa[0] == 0xFFFFFFFF
    sa_intv: int
    seq_len: int

    @classmethod
    def load(cls, prefix, reverse=False):
        ext_bwt = ".rbwt" if reverse else ".bwt"
        ext_sa = ".rsa" if reverse else ".sa"
        primary, l2, bwt, seq_len = formats.read_bwt(str(prefix) + ext_bwt)
        sa, sa_intv, sa_primary, sa_seq_len = formats.read_sa(str(prefix) + ext_sa)
        assert sa_primary == primary and sa_seq_len == seq_len, \
            "SA-BWT inconsistency"
        return cls(primary=primary, l2=l2, bwt=bwt, sa=sa, sa_intv=sa_intv,
                   seq_len=seq_len)


@dataclasses.dataclass
class BwaIndex:
    """The full index: both FM directions + packed reference + metadata.

    Mirrors what `bwa aln` + `samse/sampe` load (bwtaln.c:189-193,
    bwape.c:695-701): .bwt/.rbwt/.sa/.rsa/.pac/.ann/.amb.
    """

    fwd: FmIndex
    rev: FmIndex
    pac: np.ndarray       # base codes (unpacked uint8), length l_pac
    bns: object           # pack.BntSeq

    @classmethod
    def load(cls, prefix):
        fwd = FmIndex.load(prefix, reverse=False)
        rev = FmIndex.load(prefix, reverse=True)
        pac = packmod.read_pac(str(prefix) + ".pac")
        bns = packmod.restore_ann_amb(prefix)
        assert len(pac) == bns.l_pac
        assert fwd.seq_len == bns.l_pac
        return cls(fwd=fwd, rev=rev, pac=pac, bns=bns)

    def device_arrays(self):
        """Return a dict pytree of device-ready arrays (int32 views where
        indices fit, uint32 for SA positions)."""
        import jax.numpy as jnp

        def one(fm):
            return {
                "bwt": jnp.asarray(fm.bwt.view(np.int32)),
                "sa": jnp.asarray(fm.sa.view(np.int32)),
                "l2": jnp.asarray(fm.l2.view(np.int32)),
                "primary": jnp.asarray(np.uint32(fm.primary).view(np.int32)),
                "seq_len": jnp.asarray(np.uint32(fm.seq_len).view(np.int32)),
            }
        return {"fwd": one(self.fwd), "rev": one(self.rev)}
