"""Shared constants, mirroring the reference's compile-time parameters.

The port's copy of nabwa_tpu/constants.py, without the names the port
never reads (the word-layout sizes and the lazily built NT4 table).
Citations point into the C reference (mpieva/network-aware-bwa) so parity
can be checked; values are part of the on-disk / algorithmic contract, not
tunables.
"""

# Occ checkpoint spacing in bases (bwt.h:35, layout macros bwt.h:61-68).
OCC_INTERVAL = 0x80

# Suffix-array sampling interval (bwtindex.c:173 uses 32).
SA_INTERVAL = 32

# DFS states (bwtgap.c:7-9).
STATE_M = 0
STATE_I = 1
STATE_D = 2

# Mode bits (bwtaln.h:132-141); bits 24-31 carry the barcode length.
BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_CFY = 0x08
BWA_MODE_NONSTOP = 0x10
BWA_MODE_BAM = 0x20
BWA_MODE_BAM_SE = 0x40
BWA_MODE_BAM_READ1 = 0x80
BWA_MODE_BAM_READ2 = 0x100
BWA_MODE_IL13 = 0x200

# Alignment types (bwtaln.h:10-13).
BWA_TYPE_NO_MATCH = 0
BWA_TYPE_UNIQUE = 1
BWA_TYPE_REPEAT = 2
BWA_TYPE_MATESW = 3

# SAM flags (bwtaln.h:15-25).
SAM_FPD = 1
SAM_FPP = 2
SAM_FSU = 4
SAM_FMU = 8
SAM_FSR = 16
SAM_FMR = 32
SAM_FR1 = 64
SAM_FR2 = 128
SAM_FSC = 256
SAM_FQC = 512
SAM_FDP = 1024

BWA_AVG_ERR = 0.02  # bwtaln.h:27
BWA_MIN_RDLEN = 35  # bwtaln.h:28
BWA_MAX_BCLEN = 63  # bwtaln.h:30

# Genome pack seed (bntseq.c:181).
PAC_SEED = 11

# Read-batch chunk size used by aln/samse/sampe drivers (bwtaln.c:208 et al).
READ_CHUNK = 0x40000

# Paired-end types (bwtaln.h:155-156).
BWA_PET_STD = 1
BWA_PET_SOLID = 2
