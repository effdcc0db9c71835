"""mcraw_torch.parallel and the Decoder's mesh surface on the CPU, against
mcraw.parallel and mcraw.Decoder(backend="jax") on the conftest's 8 virtual
CPU devices: the port's mesh is ("cpu",) * 8, or ("cpu",) * 4 where the
reference takes 4 devices. Shapes and seeds follow the JAX package's mesh
tests (tests/test_pipeline.py, tests/test_pallas.py). Tolerance: 0, every
frame element-exact (the codecs are lossless and integer-only). The Pallas
kernels run in interpret mode. The same paths on the card are in
test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from mcraw import encode as E
from mcraw import parallel as JPAR
from mcraw.kernels import pallas_legacy as PL
from mcraw.kernels import pallas_unpack as PK
from mcraw.kernels import unpack as JU
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw.pipeline import Decoder as JaxDecoder

from mcraw_torch import Decoder, MotionCamException
from mcraw_torch import parallel as PAR
from mcraw_torch.kernels import legacy as L
from mcraw_torch.kernels import unpack as U
from mcraw_torch.kernels.staging import Staging

CPU = torch.device("cpu")


def jax_mesh(n: int, axis: str = "frames") -> JaxMesh:
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return JaxMesh(np.array(jax.devices()[:n]), (axis,))


def cpu_mesh(n: int) -> PAR.Mesh:
    return PAR.Mesh(("cpu",) * n)


def images(seed: int, n: int, h: int, w: int, lo: int = 0, hi: int = 4096):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, size=(h, w), dtype=np.uint16) for _ in range(n)]


def encoded(imgs, codec: int):
    enc = E.encode_modern if codec == 7 else E.encode_legacy
    return [np.frombuffer(enc(img), np.uint8) for img in imgs]


def clip_of(imgs, codec: int = 7, encoded_rows=None) -> bytes:
    """A clip of `imgs`; a modern frame with `encoded_rows` has only those
    rows encoded (a short encodedHeight)."""
    writer = E.ContainerWriter(example_container_metadata())
    rng = np.random.default_rng(len(imgs))
    for i, img in enumerate(imgs):
        h, w = img.shape
        src = img if encoded_rows is None else img[:encoded_rows]
        payload = E.encode_modern(src) if codec == 7 else E.encode_legacy(src)
        writer.add_frame(100 + i, payload, example_frame_metadata(w, h, codec))
        writer.add_audio(rng.integers(-99, 99, size=64).astype(np.int16), i * 1000)
    return writer.finish()


def check_sharded(got: PAR.Sharded, n: int, shape) -> None:
    assert isinstance(got, PAR.Sharded) and got.shape == tuple(shape)
    assert len(got.shards) == n and got.devices == (CPU,) * n
    assert all(s.device == CPU and s.dtype == torch.uint16 for s in got.shards)
    assert sum(s.shape[0] for s in got.shards) == shape[0]


# -- the mesh --------------------------------------------------------------------


def test_mesh_entries_resolve_and_may_repeat(monkeypatch):
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.devices == (CPU,) * 8 and mesh.axis == "frames"
    assert PAR.Mesh(["cpu", CPU], axis="rows").devices == (CPU, CPU)
    assert hash(mesh) == hash(cpu_mesh(8)) and mesh == cpu_mesh(8)
    with pytest.raises(ValueError, match="at least one device"):
        PAR.Mesh(())
    with pytest.raises(ValueError, match="unsupported device"):
        PAR.Mesh(("meta",))
    # No quiet CPU mesh where a cuda one was asked for.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MotionCamException, match="no CUDA device"):
        PAR.Mesh(("cuda",) * 2)
    with pytest.raises(MotionCamException, match="no CUDA device"):
        PAR.default_mesh()


def test_sharded_gathers_in_order():
    shards = (torch.arange(6).reshape(2, 3).to(torch.uint16),
              torch.arange(6, 9).reshape(1, 3).to(torch.uint16))
    s = PAR.Sharded(shards, (CPU, CPU), (3, 3))
    want = np.arange(9, dtype=np.uint16).reshape(3, 3)
    assert s.dtype == torch.uint16
    assert np.array_equal(s.numpy(), want) and np.array_equal(s.cpu().numpy(), want)
    assert np.array_equal(s.to("cpu").numpy(), want)


@pytest.mark.parametrize("rows, n", [(8, 8), (7, 3), (13, 4), (5, 5), (100, 3)])
def test_band_rows_cover_the_rows_in_order(rows, n):
    bands = PAR.band_rows(rows, n)
    assert len(bands) == n and bands[0][0] == 0 and bands[-1][1] == rows
    assert all(lo < hi for lo, hi in bands)
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))


# -- frame data-parallel batches ------------------------------------------------


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("shape", [(16, 256), (16, 250)])
def test_batch_equals_decode_frames_pallas_mesh(shape, n):
    h, w = shape
    imgs = images(1 + w + n, 8, h, w)
    payloads = encoded(imgs, 7)
    plans = [JU.prepare_modern(p, w, h) for p in payloads]
    want = JPAR.decode_frames_pallas_mesh(plans, jax_mesh(n), interpret=True)
    assert len(want.sharding.device_set) == n
    got = PAR.decode_frames_batched(payloads, w, h, True, cpu_mesh(n))
    check_sharded(got, n, (8, h, w))
    assert all(s.shape == (8 // n, h, w) for s in got.shards)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.stack(imgs))


@pytest.mark.parametrize("n", [8, 4])
@pytest.mark.parametrize("shape", [(16, 96), (16, 250)])
def test_batch_equals_decode_frames_legacy_mesh(shape, n):
    h, w = shape
    imgs = images(2 + w + n, 8, h, w)
    payloads = encoded(imgs, 6)
    plans = [JU.prepare_legacy(p, w, h) for p in payloads]
    want = JPAR.decode_frames_legacy_mesh(plans, jax_mesh(n), interpret=True)
    got = PAR.decode_frames_batched(payloads, w, h, False, cpu_mesh(n))
    check_sharded(got, n, (8, h, w))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.stack(imgs))


@pytest.mark.parametrize("content", ["mid12", "all16"])
def test_batch_equals_decode_frames_v6_mesh(content):
    """tests/test_pallas.py::test_v6_mesh_device_prep's frames."""
    h, w = 16, 256
    lo, hi = (0, 4096) if content == "mid12" else (2048, 1 << 16)
    imgs = images(3 + len(content), 8, h, w, lo, hi)
    payloads = encoded(imgs, 7)
    lights = [PK.prepare_modern_light(p, w, h) for p in payloads]
    rmax = max(len(li[0]) for li in lights)
    p32s = np.zeros((len(lights), rmax), dtype=np.int32)
    for i, li in enumerate(lights):
        p32s[i, : len(li[0])] = li[0]
    want = JPAR.decode_frames_v6_mesh(
        p32s, np.stack([li[1] for li in lights]), np.stack([li[2] for li in lights]),
        ty=lights[0][3], tx=lights[0][4], height=h, width=w,
        nfields=max(li[5][2] for li in lights), mesh=jax_mesh(4), interpret=True)
    got = PAR.decode_frames_batched(payloads, w, h, True, cpu_mesh(4))
    check_sharded(got, 4, (8, h, w))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.stack(imgs))


@pytest.mark.parametrize("shape", [(16, 96), (16, 250)])
def test_batch_equals_decode_frames_legacy_v6_mesh(shape):
    h, w = shape
    imgs = images(4 + w, 8, h, w, 0, 1 << 16)
    payloads = encoded(imgs, 6)
    lights = [PL.prepare_legacy_light(p, w, h) for p in payloads]
    rmax = max(len(li[0]) for li in lights)
    p32s = np.zeros((len(lights), rmax), dtype=np.int32)
    for i, li in enumerate(lights):
        p32s[i, : len(li[0])] = li[0]
    want = JPAR.decode_frames_legacy_v6_mesh(
        p32s, jnp.asarray(np.stack([li[1] for li in lights])),
        jnp.asarray(np.stack([li[2] for li in lights])),
        jnp.asarray(np.stack([np.asarray(li[3], np.int32) for li in lights])),
        pw=lights[0][4], h=h, width=w, rows=max(li[5] for li in lights),
        mesh=jax_mesh(4), interpret=True)
    got = PAR.decode_frames_batched(payloads, w, h, False, cpu_mesh(4))
    check_sharded(got, 4, (8, h, w))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.stack(imgs))


@pytest.mark.parametrize("modern", [True, False])
def test_batch_without_a_mesh_is_one_batched_call(modern):
    imgs = images(5, 3, 16, 128)
    payloads = encoded(imgs, 7 if modern else 6)
    mod = U if modern else L
    before = mod.PLAIN_CALLS
    got = PAR.decode_frames_batched(payloads, 128, 16, modern, staging=Staging(CPU))
    assert isinstance(got, torch.Tensor) and mod.PLAIN_CALLS == before + 1
    assert np.array_equal(got.numpy(), np.stack(imgs))


@pytest.mark.parametrize("modern", [True, False])
def test_batch_makes_one_call_per_shard(modern):
    """One batched call of the codec per shard: on the CPU, n calls of the
    plain batched version and no kernel launch."""
    imgs = images(6, 8, 8, 128)
    payloads = encoded(imgs, 7 if modern else 6)
    mod = U if modern else L
    before = (mod.PLAIN_CALLS, mod.KERNEL_LAUNCHES)
    got = PAR.decode_frames_batched(payloads, 128, 8, modern, cpu_mesh(4))
    assert (mod.PLAIN_CALLS, mod.KERNEL_LAUNCHES) == (before[0] + 4, before[1])
    assert np.array_equal(got.numpy(), np.stack(imgs))


@pytest.mark.parametrize("frames, n", [(3, 8), (6, 4), (9, 2)])
def test_uneven_batch_raises_the_reference_text(frames, n):
    imgs = images(7, frames, 16, 128)
    blob = clip_of(imgs)
    text = f"batch of {frames} not divisible by {n} devices"
    with pytest.raises(ValueError) as got:
        Decoder(blob, device="cpu").decode_batch(mesh=cpu_mesh(n))
    with pytest.raises(ValueError) as want:
        JaxDecoder(blob, backend="jax").decode_batch(mesh=jax_mesh(n))
    assert str(got.value) == str(want.value) == text


# -- one frame in row bands ----------------------------------------------------------


def test_frame_sharded_equals_reference_modern():
    """tests/test_pipeline.py::test_single_frame_sharded_across_devices's
    frame: 4 * 4 * SUBGROUPS_V5 rows, 4 chunks of the reference's, 4 bands
    of the port's."""
    h, w = 4 * 4 * PK.SUBGROUPS_V5, 2752
    (img,) = images(8, 1, h, w)
    (payload,) = encoded([img], 7)
    mesh = jax_mesh(4, "rows")
    want = JPAR.decode_frame_sharded(JU.prepare_modern(payload, w, h), mesh, interpret=True)
    got = PAR.decode_frame_sharded(payload, w, h, True, cpu_mesh(4))
    check_sharded(got, 4, (h, w))
    assert [s.shape[0] for s in got.shards] == [h // 4] * 4
    assert np.array_equal(got.numpy(), np.asarray(want)) and np.array_equal(got.numpy(), img)
    blob = clip_of([img])
    got2, meta = Decoder(blob, device="cpu").load_frame_sharded(100, cpu_mesh(4))
    want2, ref_meta = JaxDecoder(blob, backend="jax").load_frame_sharded(100, mesh)
    assert meta == ref_meta and np.array_equal(got2.numpy(), np.asarray(want2))


@pytest.mark.parametrize("shape, rows_per_chunk", [((64, 256), 16), ((16, 96), 4)])
def test_frame_sharded_equals_reference_legacy(monkeypatch, shape, rows_per_chunk):
    """tests/test_pipeline.py::test_single_legacy_frame_sharded_across_devices
    (the reference's chunks shrunk so the frame spans a multiple of 4)."""
    h, w = shape
    monkeypatch.setattr(PL, "ROWS_PER_CHUNK_LEG", rows_per_chunk)
    (img,) = images(9 + h, 1, h, w)
    (payload,) = encoded([img], 6)
    mesh = jax_mesh(4, "rows")
    want = JPAR.decode_frame_sharded_legacy(JU.prepare_legacy(payload, w, h), mesh,
                                           interpret=True)
    got = PAR.decode_frame_sharded(payload, w, h, False, cpu_mesh(4))
    check_sharded(got, 4, (h, w))
    assert np.array_equal(got.numpy(), np.asarray(want)) and np.array_equal(got.numpy(), img)
    blob = clip_of([img], codec=6)
    got2, meta = Decoder(blob, device="cpu").load_frame_sharded(100, cpu_mesh(4))
    want2, ref_meta = JaxDecoder(blob, backend="jax").load_frame_sharded(100, mesh)
    assert meta == ref_meta and np.array_equal(got2.numpy(), np.asarray(want2))


@pytest.mark.parametrize("codec, h, w, n", [
    (7, 26, 192, 3),  # 7 tile rows, the last one cropped to 2 rows
    (7, 40, 250, 4),  # 10 tile rows, W % 64 != 0
    (7, 16, 128, 4),  # one tile row a device
    (6, 13, 96, 4),
    (6, 7, 250, 7),  # one row a device, W % 32 != 0
    (6, 30, 200, 8),
])
def test_frame_sharded_uneven_bands_equal_load_frame(codec, h, w, n):
    """Bands whose row count does not divide by n: each band its own
    rows, together the frame that load_frame gives (port and JAX)."""
    (img,) = images(10 + h * w, 1, h, w)
    blob = clip_of([img], codec=codec)
    d = Decoder(blob, device="cpu")
    mod = U if codec == 7 else L
    before = mod.PLAIN_CALLS
    got, _ = d.load_frame_sharded(100, cpu_mesh(n))
    assert mod.PLAIN_CALLS == before + n  # one call a band
    check_sharded(got, n, (h, w))
    rows = -(-h // 4) if codec == 7 else h
    unit = 4 if codec == 7 else 1
    want_rows = [min(hi * unit, h) - lo * unit for lo, hi in PAR.band_rows(rows, n)]
    assert [s.shape[0] for s in got.shards] == want_rows
    assert np.array_equal(got.numpy(), img)
    assert np.array_equal(got.numpy(), d.load_frame(100)[0])
    assert np.array_equal(got.numpy(), np.asarray(JaxDecoder(blob, backend="jax").load_frame(100)[0]))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_frame_sharded_short_encoded_height(n):
    """12 of 32 rows encoded (3 encoded tile rows of 8): the output's rows
    are split, not the encoded ones; bands past the encoded rows are zeros,
    as load_frame gives them."""
    (img,) = images(11, 1, 32, 256)
    blob = clip_of([img], encoded_rows=12)
    d = Decoder(blob, device="cpu")
    got, _ = d.load_frame_sharded(100, cpu_mesh(n))
    check_sharded(got, n, (32, 256))
    want = np.zeros_like(img)
    want[:12] = img[:12]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), d.load_frame(100)[0])
    assert np.array_equal(got.numpy(), np.asarray(JaxDecoder(blob, backend="jax").load_frame(100)[0]))


@pytest.mark.parametrize("codec, h, n", [(7, 8, 3), (7, 13, 5), (6, 3, 4)])
def test_frame_sharded_raises_past_one_row_a_device(codec, h, n):
    (img,) = images(12, 1, h, 128)
    d = Decoder(clip_of([img], codec=codec), device="cpu")
    with pytest.raises(ValueError, match=f"cannot be split over {n} devices"):
        d.load_frame_sharded(100, cpu_mesh(n))


@pytest.mark.parametrize("codec", [7, 6])
def test_frame_sharded_bad_frame_raises_load_frame_text(codec):
    (img,) = images(13, 1, 16, 128)
    writer = E.ContainerWriter(example_container_metadata())
    payload = (E.encode_modern if codec == 7 else E.encode_legacy)(img)
    writer.add_frame(1, payload[: len(payload) // 2], example_frame_metadata(128, 16, codec))
    d = Decoder(writer.finish(), device="cpu")
    with pytest.raises(MotionCamException) as single:
        d.load_frame_device(1)
    with pytest.raises(MotionCamException) as sharded:
        d.load_frame_sharded(1, cpu_mesh(2))
    assert str(sharded.value) == str(single.value)
    assert str(sharded.value).startswith("Failed to uncompress")


# -- the Decoder's mesh surface ------------------------------------------------------


@pytest.mark.parametrize("codec", [7, 6])
def test_decode_batch_mesh_equals_jax(codec):
    """tests/test_pipeline.py::test_decode_batch_sharded_over_mesh's clip."""
    imgs = images(14 + codec, 8, 16, 128)
    blob = clip_of(imgs, codec=codec)
    got, metas = Decoder(blob, device="cpu").decode_batch(mesh=cpu_mesh(8))
    want, ref_metas = JaxDecoder(blob, backend="jax").decode_batch(mesh=JPAR.default_mesh())
    assert len(want.sharding.device_set) == 8 and metas == ref_metas
    check_sharded(got, 8, (8, 16, 128))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.stack(imgs))


@pytest.mark.parametrize("chunk, sizes", [(6, [8, 3]), (3, [4, 4, 3]), (16, [11])])
def test_decode_batch_iter_mesh_tail_equals_jax(chunk, sizes):
    """chunk_frames rounds up to the mesh size (8); a run that does not
    divide over the mesh decodes unsharded on the decoder's device (the
    JAX test's 11 frames with chunk_frames=6 give chunks of 8 and 3)."""
    mesh_n = 8 if chunk != 3 else 4
    imgs = images(16, 11, 16, 128)
    blob = clip_of(imgs)
    got = list(Decoder(blob, device="cpu").decode_batch_iter(chunk_frames=chunk,
                                                             mesh=cpu_mesh(mesh_n)))
    want = list(JaxDecoder(blob, backend="jax").decode_batch_iter(chunk_frames=chunk,
                                                                  mesh=jax_mesh(mesh_n)))
    assert [g[0].shape[0] for g in got] == [w[0].shape[0] for w in want] == sizes
    assert [m for _, m in got] == [m for _, m in want]
    for (a, _), (b, _) in zip(got, want, strict=True):
        sharded = a.shape[0] % mesh_n == 0
        assert isinstance(a, PAR.Sharded) == sharded
        if not sharded:
            assert a.device == CPU
        assert np.array_equal(a.numpy(), np.asarray(b))
    flat = np.concatenate([a.numpy() for a, _ in got])
    assert np.array_equal(flat, np.stack(imgs))


def test_decode_clips_equals_jax():
    """tests/test_pipeline.py::test_decode_clips_multi: 4 clips x 4 frames,
    round-robin over the 8-entry mesh; and without a mesh."""
    clips = [images(20 + c, 4, 16, 128) for c in range(4)]
    blobs = [clip_of(imgs) for imgs in clips]
    mine = [Decoder(b, device="cpu") for b in blobs]
    want, ref_metas = JPAR.decode_clips([JaxDecoder(b, backend="jax") for b in blobs],
                                        mesh=JPAR.default_mesh())
    for mesh in (cpu_mesh(8), None):
        got, metas = PAR.decode_clips(mine, mesh=mesh)
        assert got.shape == (4, 4, 16, 128) and got.dtype == torch.uint16 and got.device == CPU
        assert metas == ref_metas
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy(), np.stack([np.stack(c) for c in clips]))
    got, _ = PAR.decode_clips(mine, mesh=cpu_mesh(4), frames_per_clip=2)
    assert np.array_equal(got.numpy(), np.stack([np.stack(c[:2]) for c in clips]))


def test_decode_clips_errors_equal_jax():
    a, b = images(24, 3, 16, 128), images(25, 2, 16, 128)
    for blobs, text in (([clip_of(a), clip_of(b)], "equal frame counts"),
                        ([clip_of(b), clip_of(b, codec=6)], "mixed codecs across clips")):
        with pytest.raises(ValueError, match=text):
            PAR.decode_clips([Decoder(x, device="cpu") for x in blobs], mesh=cpu_mesh(2))
        with pytest.raises(ValueError, match=text):
            JPAR.decode_clips([JaxDecoder(x, backend="jax") for x in blobs],
                              mesh=jax_mesh(2))
    c, d = images(26, 2, 16, 128), images(27, 2, 16, 256)
    with pytest.raises(ValueError, match="share geometry"):
        PAR.decode_clips([Decoder(clip_of(x), device="cpu") for x in (c, d)])


# -- one staging per mesh entry ------------------------------------------------------


@pytest.fixture
def staging_calls(monkeypatch):
    """Records every Staging.host and Staging.upload call: (kind, staging)."""
    calls = []
    host, upload = Staging.host, Staging.upload
    monkeypatch.setattr(Staging, "host",
                        lambda self, *parts: calls.append(("host", self)) or host(self, *parts))
    monkeypatch.setattr(Staging, "upload",
                        lambda self, source=None: calls.append(("upload", self))
                        or upload(self, source))
    return calls


def test_each_mesh_entry_has_its_own_staging(staging_calls):
    """Four shards on one device never share a Staging, the Decoder keeps
    them per (mesh, codec, geometry) across calls, and an earlier result is
    not overwritten by a later call."""
    imgs = images(30, 8, 16, 128)
    d = Decoder(clip_of(imgs), device="cpu")
    mesh = cpu_mesh(4)
    first, _ = d.decode_batch(mesh=mesh)
    (ms,) = d._mesh_stagings.values()
    assert len({id(s) for s in ms.stagings}) == 4 and d._staging not in ms.stagings
    assert [s for kind, s in staging_calls if kind == "host"] == ms.stagings
    staging_calls.clear()
    second, _ = d.decode_batch(d.frames[::-1], mesh=mesh)
    assert list(d._mesh_stagings.values()) == [ms]
    assert [s for kind, s in staging_calls if kind == "host"] == ms.stagings
    assert np.array_equal(first.numpy(), np.stack(imgs))
    assert np.array_equal(second.numpy(), np.stack(imgs[::-1]))
    # One frame in bands: one host prep, replicated by each entry's upload.
    staging_calls.clear()
    band, _ = d.load_frame_sharded(d.frames[0], mesh)
    assert staging_calls == [("host", ms.stagings[0])] + [("upload", s) for s in ms.stagings]
    assert np.array_equal(band.numpy(), imgs[0])
    assert np.array_equal(first.numpy(), np.stack(imgs))
    d.decode_batch(mesh=PAR.Mesh(("cpu",) * 2))
    d.decode_batch(mesh=mesh)
    assert len(d._mesh_stagings) == 2


def test_staging_upload_of_another_stagings_layout():
    src, dst = Staging(CPU), Staging(CPU)
    a, b = src.host(((5,), np.uint8), ((2, 3), np.int64))
    a[:], b[:] = np.arange(5), [[1, -2, 3], [4, 5, -6]]
    da, db = dst.upload(src)
    assert np.array_equal(da.numpy(), np.arange(5)) and np.array_equal(db.numpy(), b)
    assert db.data_ptr() != src.upload()[1].data_ptr()  # dst's own device buffer
