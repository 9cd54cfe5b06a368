"""The port's CLI and ``Params`` accept what ``tpu_vpcc``'s do: the
no-op ``-d/--video-decoder-path`` and ``--keep-intermediate-files``, and
every ``Params`` field of the reference, by name and by position, with
the port's ``device`` after them."""

from dataclasses import MISSING, fields
from pathlib import Path

import pytest

from tpu_vpcc.runtime import cli as ref_cli
from tpu_vpcc.runtime.pipeline import Params as RefParams
from tpu_vpcc_torch.runtime import cli as port_cli
from tpu_vpcc_torch.runtime.pipeline import Params

ROOT = Path(__file__).resolve().parent.parent
VERIFY_STREAM = ROOT / "tests" / "data" / "verify_64x64_2f.bin"
REF_FIELDS = [f.name for f in fields(RefParams)]


def _value(f):
    """A value of field ``f`` other than its default."""
    if f.name == "compressed_stream_path":
        return VERIFY_STREAM
    default = f.default if f.default is not MISSING else None
    if isinstance(default, bool):
        return not default
    if isinstance(default, int):
        return default + 1
    if f.name == "mesh":
        return object()
    return Path("/nonexistent") / f.name


def test_unread_options_match_reference_cli(tmp_path):
    """The same argv with ``-d /nonexistent --keep-intermediate-files``
    through both CLIs writes the same PLY bytes."""
    argv = ["-i", str(VERIFY_STREAM), "-d", "/nonexistent",
            "--keep-intermediate-files"]
    assert ref_cli.main([*argv, "-o", str(tmp_path / "ref")]) == 0
    assert port_cli.main([*argv, "-o", str(tmp_path / "port"),
                          "--device", "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len(names) == 2
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "ref" / n).read_bytes()


def test_params_order_is_the_reference_order():
    """The reference's fields in its order, then ``device``."""
    assert [f.name for f in fields(Params)] == [*REF_FIELDS, "device"]


@pytest.mark.parametrize("name", REF_FIELDS)
def test_params_field_by_name(name):
    f = next(f for f in fields(RefParams) if f.name == name)
    value = _value(f)
    assert getattr(Params(**{name: value}), name) == value
    assert getattr(RefParams(**{name: value}), name) == value


def test_params_fields_by_position():
    """Every reference field up to ``pipeline_gofs``, given by position,
    lands on the same field of both classes."""
    upto = REF_FIELDS[: REF_FIELDS.index("pipeline_gofs") + 1]
    values = [_value(f) for f in fields(RefParams) if f.name in upto]
    port, ref = Params(*values), RefParams(*values)
    for name, value in zip(upto, values):
        assert getattr(port, name) == value, name
        assert getattr(ref, name) == value, name
    assert port.device == "cuda"


def test_ply_writer_tries_the_bridge_once(monkeypatch):
    """Where the native bridge cannot load (a machine without
    libavcodec), the ASCII writer falls back to numpy for every frame
    after one failed load, not one build attempt a frame."""
    import numpy as np

    from tpu_vpcc_torch.reconstruction.pointset import PointSet3
    from tpu_vpcc_torch.utils import ply
    from tpu_vpcc_torch.video import codec

    ps = PointSet3(positions=np.array([[1, 2, 3], [4, 5, 6]], np.uint16),
                   colors=np.array([[7, 8, 9], [10, 11, 12]], np.uint8),
                   with_colors=True)
    want = ply.format_ply(ps)
    calls = []

    def no_bridge():
        calls.append(1)
        raise OSError("no libavcodec")

    monkeypatch.setattr(codec, "_load", no_bridge)
    monkeypatch.setattr(ply, "_ply_lib", None)
    assert [ply.format_ply(ps) for _ in range(3)] == [want] * 3
    assert len(calls) == 1
