"""The port's copies of the last host helpers of ``tpu_vpcc.video``:
``video.codec.decoder_thread_info`` (the native decoder's threading, as
``tests/test_video.py`` checks it on the reference) and the plane
stackers ``occupancy_planes``, ``geometry_planes`` and
``attribute_planes``, against the reference's on the video store's
decoded frames. ``tests/test_torch_copies.py`` holds their sources to
the reference's, word for word."""

import os

import numpy as np
import pytest

from tpu_vpcc import video as ref_video
from tpu_vpcc_torch import video
from tpu_vpcc_torch.tools.video_store import VideoStore


def test_decoder_threading_configuration():
    """The port's bridge requests frame+slice threading with an automatic
    thread count: on a host of several cores frame threading engages;
    on one core one thread is the right resolution. An explicit request
    of four threads engages frame threading on any host."""
    from tpu_vpcc_torch.video.codec import decoder_thread_info

    count, active = decoder_thread_info(1)
    assert count >= 1
    if (os.cpu_count() or 1) > 1:
        # FF_THREAD_FRAME = 1: frame threads scale across cores
        assert count > 1, "auto thread count should resolve to > 1 core"
        assert active & 1, "frame threading should be active for HEVC"
    else:
        assert count == 1
    count4, active4 = decoder_thread_info(1, threads=4)
    assert count4 == 4
    assert active4 & 1, "frame threading must engage with 4 threads"


def _stored_videos(name):
    """Each decoded result of the store's entry ``name`` (raster planes:
    tile 0), by its codec's bit depth."""
    store = VideoStore()
    calls = [c for c in store.entries[name].calls if c["key"].endswith(":0")]
    return [store.frames(c["key"]) for c in calls]


@pytest.mark.parametrize("name", ["verify", "graft_dryrun_d4", "chroma422"])
def test_plane_stackers_match_reference(name):
    """``occupancy_planes`` on the 8-bit videos, ``geometry_planes`` and
    ``attribute_planes`` on every video: the same arrays, dtypes and
    shapes as the reference's; a 10-bit occupancy video is refused by
    both."""
    videos = _stored_videos(name)
    assert videos
    for frames in videos:
        for fn in ("geometry_planes", "attribute_planes"):
            got = getattr(video, fn)(frames)
            ref = getattr(ref_video, fn)(frames)
            if fn == "geometry_planes":
                assert got.dtype == ref.dtype == np.uint16
                np.testing.assert_array_equal(got, ref)
            else:
                assert len(got) == len(ref) == len(frames)
                for g, r in zip(got, ref):
                    for a, b in zip(g, r):
                        assert a.dtype == b.dtype == np.uint16
                        np.testing.assert_array_equal(a, b)
        if frames[0].bit_depth == 8:
            got = video.occupancy_planes(frames)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got,
                                          ref_video.occupancy_planes(frames))
        else:
            for mod in (video, ref_video):
                with pytest.raises(ValueError, match="must be 8-bit"):
                    mod.occupancy_planes(frames)
    assert {f[0].bit_depth for f in videos} == {8, 10}
