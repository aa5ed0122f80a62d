"""Host IO: the ASCII<->2-bit codec and FASTA/FASTQ reading, whole or in packed blocks."""

from tpu_debruijn_torch.io.native import (
    ascii_to_codes,
    codes_to_ascii,
    native_available,
    pack_codes,
    rc_codes,
    unpack_codes,
)
from tpu_debruijn_torch.io.fastx import read_fasta, read_fastq, read_fastx, stream_fastx_blocks

__all__ = [
    "ascii_to_codes",
    "codes_to_ascii",
    "native_available",
    "pack_codes",
    "rc_codes",
    "unpack_codes",
    "read_fasta",
    "read_fastq",
    "read_fastx",
    "stream_fastx_blocks",
]
