"""The port's staging arena (renderer_tpu_torch/runtime/allocator.py over
renderer_tpu/native/arena.cc, built by path) through the six cases of the
JAX package's tests/test_allocator.py, on the CPU; and on the card, its
block page-locked: staged tensors report is_pinned() and copy to the card
without blocking."""

import numpy as np
import pytest
import torch

from renderer_tpu_torch.runtime.allocator import Arena as _Arena


def Arena(capacity):
    return _Arena(capacity, device="cpu")


def test_alloc_free_stats():
    a = Arena(1 << 20)
    s0 = a.stats()
    assert s0["capacity"] == 1 << 20
    assert s0["used"] == 0 and s0["free_block_count"] == 1

    x = a.alloc((1000,), np.float32)
    x[:] = np.arange(1000, dtype=np.float32)
    s1 = a.stats()
    assert s1["used"] == 4000 and s1["live_allocs"] == 1
    np.testing.assert_array_equal(x[:5], [0, 1, 2, 3, 4])

    a.free(x)
    s2 = a.stats()
    assert s2["used"] == 0 and s2["live_allocs"] == 0
    assert s2["peak_used"] == 4000
    assert s2["total_allocs"] == 1
    # fully coalesced back to one block
    assert s2["free_block_count"] == 1
    assert s2["largest_free_block"] == 1 << 20
    a.close()


def test_coalescing_and_reuse():
    a = Arena(1 << 16)
    xs = [a.alloc((1024,), np.uint8) for _ in range(8)]
    assert a.stats()["live_allocs"] == 8
    # free every other, then the rest: must coalesce to one block
    for x in xs[::2]:
        a.free(x)
    assert a.stats()["free_block_count"] >= 4
    for x in xs[1::2]:
        a.free(x)
    s = a.stats()
    assert s["free_block_count"] == 1
    assert s["largest_free_block"] == 1 << 16
    a.close()


def test_alignment():
    a = Arena(1 << 16)
    x = a.alloc((3,), np.uint8, align=256)
    y = a.alloc((3,), np.uint8, align=256)
    assert x.ctypes.data % 256 == 0
    assert y.ctypes.data % 256 == 0
    a.close()


def test_exhaustion_and_failed_stat():
    a = Arena(4096)
    big = a.alloc((4000,), np.uint8)
    with pytest.raises(MemoryError):
        a.alloc((4096,), np.uint8)
    assert a.stats()["failed_allocs"] == 1
    a.free(big)
    # after free the same alloc succeeds
    ok = a.alloc((4000,), np.uint8)
    assert ok.nbytes == 4000
    a.close()


def test_double_free_rejected():
    a = Arena(4096)
    x = a.alloc((16,), np.uint8)
    a.free(x)
    with pytest.raises(ValueError):
        a.free(x)
    a.close()


def test_many_random_allocs():
    rng = np.random.default_rng(0)
    a = Arena(1 << 20)
    live = []
    for _ in range(500):
        if live and rng.random() < 0.45:
            i = int(rng.integers(len(live)))
            a.free(live.pop(i))
        else:
            try:
                live.append(a.alloc((int(rng.integers(1, 8192)),), np.uint8))
            except MemoryError:
                pass
    s = a.stats()
    assert s["live_allocs"] == len(live)
    for x in live:
        a.free(x)
    assert a.stats()["free_block_count"] == 1
    a.close()


def test_arena_matches_the_jax_arena():
    """The same alloc/free sequence gives the same stats in both packages
    (one native source, two bindings)."""
    from renderer_tpu.runtime.allocator import Arena as JaxArena

    rng = np.random.default_rng(1)
    a, j = Arena(1 << 16), JaxArena(1 << 16)
    live = []
    for _ in range(200):
        if live and rng.random() < 0.4:
            x, y = live.pop(int(rng.integers(len(live))))
            a.free(x)
            j.free(y)
        else:
            n = int(rng.integers(1, 4096))
            try:
                x = a.alloc((n,), np.uint8)
            except MemoryError:
                with pytest.raises(MemoryError):
                    j.alloc((n,), np.uint8)
                continue
            live.append((x, j.alloc((n,), np.uint8)))
        assert a.stats() == j.stats()
    a.close()
    j.close()


@pytest.mark.gpu
def test_arena_block_is_page_locked_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = _Arena(1 << 20, device="cuda")
    assert a.pinned
    x = a.alloc((1000,), np.float32)
    x[:] = np.arange(1000, dtype=np.float32)
    staged = torch.from_numpy(x)
    assert staged.is_pinned()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev = staged.to("cuda", non_blocking=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu(), staged)
    a.free(x)
    a.close()
    assert not a.pinned
