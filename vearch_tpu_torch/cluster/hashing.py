"""Murmur3-32 and slot-range partitioning.

Byte-compatible with the reference's doc routing (reference:
internal/client/client.go:245 `murmur3.Sum32WithSeed([]byte(doc.PKey), 0)`
and entity/space.go:153 `Space.PartitionId` binary search over partition
slot starts carved as i * (MaxUint32 / partition_num),
master/services/space_service.go:158).
"""

from __future__ import annotations

MAX_UINT32 = 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit (same algorithm as spaolacci/murmur3 Sum32)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & MAX_UINT32
    length = len(data)
    rounded = length - (length % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & MAX_UINT32
        k = ((k << 15) | (k >> 17)) & MAX_UINT32
        k = (k * c2) & MAX_UINT32
        h ^= k
        h = ((h << 13) | (h >> 19)) & MAX_UINT32
        h = (h * 5 + 0xE6546B64) & MAX_UINT32
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & MAX_UINT32
        k = ((k << 15) | (k >> 17)) & MAX_UINT32
        k = (k * c2) & MAX_UINT32
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & MAX_UINT32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & MAX_UINT32
    h ^= h >> 16
    return h


def key_slot(key: str) -> int:
    return murmur3_32(key.encode("utf-8"), 0)


def carve_slots(partition_num: int) -> list[int]:
    """Slot start per partition (reference: space_service.go:158)."""
    width = MAX_UINT32 // partition_num
    return [i * width for i in range(partition_num)]


def partition_for_slot(slot_starts: list[int], slot: int) -> int:
    """Index of the partition owning `slot` (binary search over starts —
    reference: entity/space.go:153)."""
    if len(slot_starts) == 1:
        return 0
    lo, hi = 0, len(slot_starts) - 1
    while lo <= hi:
        mid = (lo + hi) >> 1
        v = slot_starts[mid]
        if v > slot:
            hi = mid - 1
        elif v < slot:
            lo = mid + 1
        else:
            return mid
    return lo - 1
