"""The committed video store (``tpu_vpcc_torch/tools/video_store.py``,
``tests/data/video_store/``): every fixture family of
``test_torch_e2e.STREAMS``, one 1280^2 lossy stream, the stream of
``examples/roundtrip.py`` and the graft dry run's streams at 1-4 'data'
rows, each with the frames the native libavcodec bridge decoded from
its HEVC sub-bitstreams and the SHA-256 of the PLY files ``tpu_vpcc``'s
CLI writes; and the ``encoded`` table, by which the
port's ``build_fixture_stream`` rebuilds every stream without libx265
(``tests/test_torch_encoder.py``).

On the CPU, every entry decodes under ``served`` through the port's CLI
(device path and oracle) to its manifest's digests and kernel wrapper
calls; where the bridge loads, the bridge gives the stored frames and
``tpu_vpcc``'s CLI and oracle (JAX on the CPU) the stored digests. On the
card (``pytest -m cuda``) a narrow, a wide and a gather entry decode
with ``--device cuda`` to the same digests and kernel launches.

Rebuild the store, on a machine with libavcodec and libx265 (every
entry, or the entries named; libx265's output for some inputs differs
from run to run, so rebuilding an entry may change its stream), then
record the ``encoded`` table anew (without libx265):

    python tests/test_torch_video_store.py --write [NAME ...]

Record the ``encoded`` table alone, anywhere (no libavcodec needed):

    python tests/test_torch_video_store.py --record
"""

import hashlib
import importlib
import json
import re
import runpy
import shutil
import sys
import tempfile
import threading
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

if __name__ == "__main__":  # as a script: the repository on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_vpcc_torch.ops.tiled import native_pack_available
from tpu_vpcc_torch.runtime import cli as port_cli
from tpu_vpcc_torch.runtime import pipeline
from tpu_vpcc_torch.tools.video_store import (
    FLAGSHIP_BUILD,
    KERNELS,
    MANIFEST,
    STORE_DIR,
    StoreMiss,
    VideoStore,
    annexb,
    flagship_frames,
    record_encoded,
    recording,
    served,
    video_units,
    write_entry,
    write_manifest,
)

ROOT = Path(__file__).resolve().parent.parent
FLAGSHIP = "flagship_1280_q8"
#: the stream of ``examples/roundtrip.py``
ROUNDTRIP = "roundtrip"
#: the graft dry run's streams (``graft_entry.dryrun_stream``), by 'data'
#: rows: meshes of 1, 2, 3, 4 and 8 devices have 1, 1, 3, 2 and 4 rows
DRYRUN_ROWS = (1, 2, 3, 4)
DRYRUNS = tuple(f"graft_dryrun_d{d}" for d in DRYRUN_ROWS)
#: the store's entries: ``test_torch_e2e.STREAMS``, the 1280^2 stream, the
#: roundtrip example's and the graft dry run's
NAMES = (
    "atlas_hash", "aux_raw", "chroma422", "multi_tile_aux",
    "pixel_interleave", "plr", "proj45", "proj45_three_maps",
    "raw_eom_secondary", "rotated", "rotated_smoothing_secondary",
    "rotated_three_maps", "smoothing", "smoothing_secondary", "three_maps",
    "verify", "vui", FLAGSHIP, ROUNDTRIP, *DRYRUNS,
)
#: a narrow (K1), a wide (K2W, K1F) and a gather (K1F) entry
ON_CARD = ("verify", "smoothing", "rotated")
#: the several-``-i`` CLI run of the manifest's ``multi``
MULTI = ("verify", "atlas_hash", "smoothing")
SMOOTHING_FLAGS = ["--apply-geo-smoothing", "--apply-attr-smoothing"]
#: the CLI flag of each ``Params`` keyword an entry decodes with
FLAG_OF = {
    "apply_geo_smoothing_type": "--apply-geo-smoothing",
    "apply_attr_smoothing_type": "--apply-attr-smoothing",
    "apply_occupancy_synthesis_type": "--apply-occupancy-synthesis",
}
#: the store's size limit, bytes
MAX_STORE_BYTES = 12 * 2 ** 20


@pytest.fixture(scope="module")
def store():
    return VideoStore()


def outputs_of(out_dir):
    """Each PLY file under ``out_dir``: its name, point count and
    SHA-256, as the manifest lists them."""
    rows = []
    for p in sorted(Path(out_dir).glob("*.ply")):
        data = p.read_bytes()
        points = int(re.search(rb"element vertex (\d+)", data).group(1))
        rows.append({"name": p.name, "points": points,
                     "sha256": hashlib.sha256(data).hexdigest()})
    return rows


def cli_outputs(main, stream, out_dir, args):
    """``main(["-i", stream, "-o", out_dir, *args])`` must return 0;
    :func:`outputs_of` the directory."""
    rc = main(["-i", str(stream), "-o", str(out_dir), *args])
    assert rc == 0, f"{main.__module__} exited {rc} on {stream}"
    return outputs_of(out_dir)


@contextmanager
def wrapper_calls():
    """Count the calls of the kernel wrappers K1 (``shift_compact_ops``),
    K2W (``wide_words``) and K1F (``shift_compact_full``). On a CPU
    tensor each runs its plain version; on the card each call is one
    launch."""
    from tpu_vpcc_torch.ops import payload, shift_compact, tiled

    targets = {"K1": (tiled, "shift_compact_ops"),
               "K2W": (payload, "wide_words"),
               "K1F": (shift_compact, "shift_compact_full")}
    counts = dict.fromkeys(KERNELS, 0)
    lock = threading.Lock()
    originals = {k: getattr(mod, attr) for k, (mod, attr) in targets.items()}

    def spy(k):
        def call(*args, **kw):
            with lock:
                counts[k] += 1
            return originals[k](*args, **kw)
        return call

    for k, (mod, attr) in targets.items():
        setattr(mod, attr, spy(k))
    try:
        yield counts
    finally:
        for k, (mod, attr) in targets.items():
            setattr(mod, attr, originals[k])


def test_manifest_lists_every_entry(store):
    """The 23 entries, each with outputs, decoded results and its kernel
    path; the multi-stream run; the whole store under 12 MiB."""
    assert tuple(sorted(store.entries)) == tuple(sorted(NAMES))
    for name, e in store.entries.items():
        assert e.stream.is_file(), name
        assert e.outputs and all(o["points"] > 0 for o in e.outputs), name
        assert e.calls, name
        assert set(e.launches) == set(KERNELS), name
        # every device decode compacts: K1 on the narrow path, K1F on
        # the wide path (after K2W) and the gather fallback
        assert e.launches["K1"] + e.launches["K1F"] > 0, name
    assert store.entries["verify"].launches["K1"] > 0
    assert store.entries["smoothing"].launches["K2W"] > 0
    rot = store.entries["rotated"].launches
    assert rot["K1F"] > 0 and rot["K1"] == rot["K2W"] == 0
    flagship = store.entries[FLAGSHIP]
    assert flagship.launches["K1"] > 0 and flagship.launches["K1F"] == 0
    assert min(o["points"] for o in flagship.outputs) > 900_000
    roundtrip = store.entries[ROUNDTRIP]
    assert [o["name"] for o in roundtrip.outputs] == [
        f"{i:04d}.ply" for i in range(4)]
    assert roundtrip.launches["K1"] > 0
    for d, name in zip(DRYRUN_ROWS, DRYRUNS):
        assert len(store.entries[name].outputs) == d, name
    assert store.multi == {"entries": list(MULTI), "flags": SMOOTHING_FLAGS}
    size = sum(p.stat().st_size for p in STORE_DIR.iterdir())
    assert size < MAX_STORE_BYTES, size


@pytest.mark.parametrize("name", NAMES)
def test_entry_decodes_to_manifest(name, store, tmp_path):
    """Under ``served``, the port's CLI on the CPU (device path and
    oracle) writes the manifest's files, and the device path calls each
    kernel wrapper as often as the manifest says."""
    e = store.entries[name]
    hits = store.hits
    with served(store), wrapper_calls() as calls:
        got = cli_outputs(port_cli.main, e.stream, tmp_path / "dev",
                          ["--device", "cpu", *e.flags])
        assert calls == e.launches
        oracle = cli_outputs(port_cli.main, e.stream, tmp_path / "oracle",
                             ["--oracle", *e.flags])
    assert got == e.outputs
    assert oracle == e.outputs
    assert store.hits > hits


def _same_frames(a, b) -> bool:
    return len(a) == len(b) and all(
        (x.bit_depth, x.chroma_w_shift, x.chroma_h_shift, x.is_rgb)
        == (y.bit_depth, y.chroma_w_shift, y.chroma_h_shift, y.is_rgb)
        and all(p.dtype == q.dtype and p.shape == q.shape
                and np.array_equal(p, q) for p, q in zip(x.planes, y.planes))
        for x, y in zip(a, b)
    )


@pytest.mark.parametrize("name", [
    # over 60 s on one CPU core: JAX's decodes at 1280^2
    pytest.param(n, marks=pytest.mark.slow) if n == FLAGSHIP else n
    for n in NAMES
])
def test_entry_matches_bridge_and_reference(name, store, tmp_path):
    """Where the bridge loads: the port's CLI through the bridge asks for
    exactly the entry's decoded results and gets the stored frames, and
    writes the manifest's files; so do ``tpu_vpcc``'s CLI and oracle."""
    if not native_pack_available():
        pytest.skip("the native video bridge (libavcodec) does not load")
    from tpu_vpcc.runtime import cli as ref_cli

    e = store.entries[name]
    calls = {}
    with recording(calls):
        got = cli_outputs(port_cli.main, e.stream, tmp_path / "dev",
                          ["--device", "cpu", *e.flags])
        oracle = cli_outputs(port_cli.main, e.stream, tmp_path / "oracle",
                             ["--oracle", *e.flags])
    assert set(calls) == {c["key"] for c in e.calls}
    for key, frames in calls.items():
        assert _same_frames(frames, store.frames(key)), key
    assert got == oracle == e.outputs
    assert cli_outputs(ref_cli.main, e.stream, tmp_path / "ref",
                       e.flags) == e.outputs
    assert cli_outputs(ref_cli.main, e.stream, tmp_path / "ref_oracle",
                       ["--oracle", *e.flags]) == e.outputs


def test_missing_key_raises(store, tmp_path):
    """A lookup the store does not hold raises :class:`StoreMiss`, and a
    decode that needs one fails: no fall-through to the bridge."""
    key = store.entries["verify"].calls[0]["key"]
    with pytest.raises(StoreMiss, match="holds no decode"):
        store.frames(key.rsplit(":", 1)[0] + ":7")
    with pytest.raises(StoreMiss):
        store.lookup(b"not a sub-bitstream", 1)
    # the verify entry without its first decoded result
    part = tmp_path / "store"
    part.mkdir()
    manifest = json.loads((STORE_DIR / MANIFEST).read_text())
    e = manifest["entries"]["verify"]
    e["calls"] = e["calls"][1:]
    manifest["entries"] = {"verify": e}
    e["stream"] = str(store.entries["verify"].stream)
    (part / MANIFEST).write_text(json.dumps(manifest))
    for npz in {c["npz"] for c in e["calls"]}:
        shutil.copy(STORE_DIR / f"{npz}.npz", part / f"{npz}.npz")
    partial = VideoStore(part)
    argv = ["-i", e["stream"], "-o", str(tmp_path / "out"), "--device", "cpu"]
    with served(partial):
        assert port_cli.main(argv) == 1
        with pytest.raises(StoreMiss, match=key):
            port_cli.main([*argv, "-v"])


def test_servings_are_independent(store, tmp_path):
    """Each lookup returns new frames: changing one in place, as the
    4:2:2 path does, leaves the next lookup intact; the 4:2:2 entry
    decodes twice in one serving to its digests."""
    e = store.entries["chroma422"]
    key = e.calls[0]["key"]
    a, b = store.frames(key), store.frames(key)
    assert a[0] is not b[0]
    assert not np.shares_memory(a[0].planes[1], b[0].planes[1])
    for f in a:
        f.planes[1] = np.repeat(f.planes[1], 2, axis=1)
        f.planes[2][...] = 0
        f.chroma_w_shift = 0
    assert _same_frames(store.frames(key), b)
    with served(store):
        for k in range(2):
            assert cli_outputs(port_cli.main, e.stream, tmp_path / f"{k}",
                               ["--device", "cpu"]) == e.outputs


def test_served_restores_decompress_video(store):
    original = pipeline.decompress_video
    with served(store):
        assert pipeline.decompress_video == store.lookup
    assert pipeline.decompress_video is original
    with pytest.raises(RuntimeError, match="inside"):
        with served(store):
            raise RuntimeError("inside")
    assert pipeline.decompress_video is original
    with pytest.raises(RuntimeError, match="inside"):
        with recording({}):
            raise RuntimeError("inside")
    assert pipeline.decompress_video is original


def test_multi_stream_cli_matches_single(store, tmp_path):
    """The several-``-i`` CLI over the manifest's ``multi`` entries writes
    per-stream directories equal to the single-stream outputs."""
    entries = [store.entries[n] for n in store.multi["entries"]]
    argv = [a for e in entries for a in ("-i", str(e.stream))]
    with served(store):
        assert port_cli.main([*argv, "-o", str(tmp_path), "--device", "cpu",
                              *store.multi["flags"]]) == 0
    for e in entries:
        assert outputs_of(tmp_path / e.stream.stem) == e.outputs, e.name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ON_CARD)
def test_entry_on_card(name, store, tmp_path):
    """A narrow, a wide and a gather entry through the port's CLI with
    ``--device cuda`` under ``served``: the manifest's files, and the
    kernels launched as the manifest says."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: pytest -m cuda)")
    from tpu_vpcc_torch.ops import payload
    from tpu_vpcc_torch.ops import shift_compact as sc

    e = store.entries[name]
    sc.reset_launches()
    payload.reset_launches()
    with served(store):
        got = cli_outputs(port_cli.main, e.stream, tmp_path,
                          ["--device", "cuda", *e.flags])
    assert got == e.outputs
    assert {"K1": sc.launches, "K2W": payload.launches,
            "K1F": sc.full_launches} == e.launches


# ---------------------------------------------------------------------------
# building the store
# ---------------------------------------------------------------------------


def reference_roundtrip(out_dir) -> bytes:
    """Run ``examples/roundtrip.py`` into ``out_dir`` (synthesis, its
    encoder, ``tpu_vpcc``'s decode, PLY files); its stream."""
    argv = sys.argv
    sys.argv = [str(ROOT / "examples" / "roundtrip.py"), str(out_dir)]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    finally:
        sys.argv = argv
    return (Path(out_dir) / "stream.bin").read_bytes()


def reference_dryrun_stream(data: int) -> bytes:
    """The stream that the root ``__graft_entry__.dryrun_multichip``
    authors at ``data`` 'data' rows (its lines, copied: the module can
    only be run whole), with ``tpu_vpcc``'s scene generator and
    ``build_fixture_stream``."""
    from tpu_vpcc.utils.fixtures import build_fixture_stream
    from tpu_vpcc.utils.synthetic import make_synthetic_frame

    rng = np.random.default_rng(51)
    sfs = [
        make_synthetic_frame(
            rng, width=64, height=64, occupancy_resolution=8,
            occupancy_precision=4, map_count=2, n_patches=3, frame_index=i,
        )
        for i in range(data)  # one frame per 'data' row
    ]
    return build_fixture_stream(sfs, atlas_hash_sei=True)


def recipe(name: str, package: str) -> bytes:
    """Entry ``name``'s stream as ``package`` (``"tpu_vpcc"`` or
    ``"tpu_vpcc_torch"``) builds it with its own ``build_fixture_stream``
    (and so with whatever its ``utils.fixtures.encode_yuv420`` is): a
    family of ``test_torch_e2e.RECIPES`` under ``built_with(package)``,
    ``flagship_1280_q8`` from ``flagship_frames`` on the package's scene
    generator, ``roundtrip`` by the package's roundtrip example (for
    ``tpu_vpcc``, ``examples/roundtrip.py`` run whole), and
    ``graft_dryrun_d<rows>`` by the package's graft dry run
    (:func:`reference_dryrun_stream`, ``graft_entry.dryrun_stream``)."""
    from test_torch_e2e import RECIPES, built_with

    if name in DRYRUNS:
        data = DRYRUN_ROWS[DRYRUNS.index(name)]
        if package == "tpu_vpcc":
            return reference_dryrun_stream(data)
        from tpu_vpcc_torch.graft_entry import dryrun_stream

        return dryrun_stream(data)
    if name == ROUNDTRIP and package == "tpu_vpcc":
        with tempfile.TemporaryDirectory() as tmp:
            return reference_roundtrip(tmp)
    fixtures = importlib.import_module(f"{package}.utils.fixtures")
    if name == ROUNDTRIP:
        from tpu_vpcc_torch.examples.roundtrip import scene

        return fixtures.build_fixture_stream(scene())
    if name == FLAGSHIP:
        synthetic = importlib.import_module(f"{package}.utils.synthetic")
        return fixtures.build_fixture_stream(
            flagship_frames(synthetic.make_synthetic_frame), **FLAGSHIP_BUILD)
    with built_with(package):
        return RECIPES[name]()


def record_store(root, entries: dict) -> dict:
    """The ``encoded`` table of the entries (manifest records by name):
    each entry's table from ``record_encoded`` on the port's recipe and
    the entry's committed stream, merged. A key that two entries share
    must stand for the same sub-bitstream in both."""
    root = Path(root)
    encoded = {}
    for name in NAMES:
        stream = (root / entries[name]["stream"]).read_bytes()
        table = record_encoded(
            name, stream, lambda: recipe(name, "tpu_vpcc_torch"))
        for key, where in table.items():
            first = encoded.setdefault(key, where)
            if first is not where:
                held = (root / entries[first["entry"]]["stream"]).read_bytes()
                assert annexb(video_units(held)[first["unit"]]) == \
                    annexb(video_units(stream)[where["unit"]]), (name, key)
        print(f"{name}: {len(table)} encodes rebuild the stream")
    return encoded


def build_store(root, names=NAMES) -> None:
    """Encode the entries ``names`` (an entry not named keeps its files
    and manifest record), decode each with ``tpu_vpcc``'s CLI (its
    digests) and oracle, and with the port's ``Decoder`` on the CPU,
    oracle and CLI under :func:`recording`; write the entries, then run
    the several-``-i`` CLI (whose decoded results the entries must
    already hold), record the ``encoded`` table and write the
    manifest."""
    from test_torch_e2e import STREAM_PARAMS, VERIFY_STREAM
    from tpu_vpcc.runtime import cli as ref_cli
    from tpu_vpcc_torch.runtime.pipeline import Decoder, Params
    from tpu_vpcc_torch.utils.ply import format_ply

    assert set(names) <= set(NAMES), sorted(set(names) - set(NAMES))
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    entries, written = {}, {}
    if (root / MANIFEST).is_file():
        kept = {n: e for n, e in
                json.loads((root / MANIFEST).read_text())["entries"].items()
                if n not in names}
        for n, e in kept.items():
            held = {c["npz"] for c in e["calls"]}
            assert held <= set(kept), \
                f"{n} reads {held}: rebuild them together"
            written.update((c["key"], c) for c in e["calls"])
        entries.update(kept)
    for name in names:
        for old in (root / f"{name}.v3c", root / f"{name}.npz"):
            old.unlink(missing_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in names:
            params = STREAM_PARAMS.get(name, {})
            flags = [FLAG_OF[k] for k, v in params.items() if v]
            src = tmp / f"{name}.v3c"
            if name == "verify":
                stream = VERIFY_STREAM
                shutil.copy(VERIFY_STREAM, src)
            elif name == ROUNDTRIP:
                stream = reference_roundtrip(tmp / "roundtrip_example")
                src.write_bytes(stream)
            else:
                stream = recipe(name, "tpu_vpcc")
                src.write_bytes(stream)
            ref = cli_outputs(ref_cli.main, src, tmp / name / "ref", flags)
            assert cli_outputs(ref_cli.main, src, tmp / name / "ref_oracle",
                               ["--oracle", *flags]) == ref, name
            if name == ROUNDTRIP:
                assert outputs_of(tmp / "roundtrip_example") == ref, name
            calls = {}
            with recording(calls):
                with wrapper_calls() as launches:
                    got = cli_outputs(port_cli.main, src, tmp / name / "port",
                                      ["--device", "cpu", *flags])
                oracle = cli_outputs(port_cli.main, src,
                                     tmp / name / "port_oracle",
                                     ["--oracle", *flags])
                dec = Decoder(Params(src, device="cpu", **params))
                dec.start()
                plys = [format_ply(f) for f in dec]
            assert got == oracle == ref, name
            assert [hashlib.sha256(p).hexdigest() for p in plys] == \
                [o["sha256"] for o in ref], name
            entries[name] = write_entry(
                root, name, stream, calls, written, flags=flags,
                params=params, outputs=ref, launches=dict(launches),
            )
            print(f"{name}: {len(ref)} frames, "
                  f"{[o['points'] for o in ref]} points, "
                  f"{len(calls)} decoded results, launches {dict(launches)}")
        multi_dir = tmp / "multi"
        paths = [tmp / "multi_in" / f"{n}.v3c" for n in MULTI]
        paths[0].parent.mkdir()
        for n, path in zip(MULTI, paths):
            shutil.copy(root / entries[n]["stream"], path)
        calls = {}
        with recording(calls):
            assert port_cli.main(
                [a for p in paths for a in ("-i", str(p))]
                + ["-o", str(multi_dir), "--device", "cpu", *SMOOTHING_FLAGS]
            ) == 0
        assert set(calls) <= set(written), set(calls) - set(written)
        for n in MULTI:
            assert outputs_of(multi_dir / n) == entries[n]["outputs"], n
    entries = {n: entries[n] for n in NAMES}
    write_manifest(root, entries, {"entries": list(MULTI),
                                   "flags": SMOOTHING_FLAGS},
                   record_store(root, entries))
    sizes = {p.name: p.stat().st_size for p in sorted(root.iterdir())}
    for n, s in sizes.items():
        print(f"{n}: {s} bytes")
    total = sum(sizes.values())
    print(f"store: {total} bytes")
    assert total < MAX_STORE_BYTES, total


def record_manifest(root) -> None:
    """Record the ``encoded`` table of the store at ``root`` anew and
    write it into its manifest; needs no libavcodec or libx265."""
    manifest = json.loads((Path(root) / MANIFEST).read_text())
    write_manifest(root, manifest["entries"], manifest["multi"],
                   record_store(root, manifest["entries"]))


if __name__ == "__main__":
    if sys.argv[1:2] not in (["--write"], ["--record"]):
        sys.exit("usage: python tests/test_torch_video_store.py "
                 "--write [NAME ...] | --record")
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "--record":
        record_manifest(STORE_DIR)
    else:
        build_store(STORE_DIR, tuple(sys.argv[2:]) or NAMES)
