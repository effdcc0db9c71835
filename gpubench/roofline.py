"""The yardstick of the kernels: the bytes a step must move, the published
peaks, and which step each of the program's kernels belongs to.

A roofline share is the least time the step's bytes need at the card's
published bandwidth, divided by the device time the trace gives the step.
Each input byte is counted once and each output byte once, from the cell's
own inputs; what one kernel hands to the next (the modern block offsets)
is not counted, so a step whose kernels are merged reads the same work.
"""

from __future__ import annotations

# Published peaks by torch.cuda.get_device_name(): HBM bytes/s (NVIDIA
# H100 SXM data sheet, at its 700 W limit).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# Where the trace cannot tie a kernel to the harness's span that launched
# it, its name does; a memset belongs to the kernel after it on its stream.
KERNEL_STEP = {
    "block_offsets_kernel": "offsets",
    "unpack_modern_kernel": "decode",
    "unpack_legacy_kernel": "decode",
    "develop_kernel": "develop",
    "checksum_kernel": "checksum",
}
# The roofline steps and the spans that make them up.
STEPS = {"decode": ("offsets", "decode"), "develop": ("develop",)}


def modern_blocks(width: int, height: int) -> int:
    return 4 * ((height + 3) // 4) * ((width + 63) // 64)


def legacy_blocks(width: int, height: int) -> int:
    return height * ((width + 31) // 32) * 2


def decode_bytes(codec: str, payload_bytes: int, width: int, height: int) -> int:
    """One frame's decode: in, the payload and what the host scan hands the
    card (modern: the uint16 bits and refs of each block; legacy: each
    block's int32 bits, uint16 ref and int64 offset); out, the uint16
    plane."""
    if codec == "modern":
        scanned = modern_blocks(width, height) * (2 + 2)
    elif codec == "legacy":
        scanned = legacy_blocks(width, height) * (4 + 2 + 8)
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return payload_bytes + scanned + 2 * width * height


def develop_bytes(width: int, height: int) -> int:
    """One frame's develop: the uint16 plane in, the uint32 RGBA out."""
    return (2 + 4) * width * height
