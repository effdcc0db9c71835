"""Frames developed each with its own clip's and frame's metadata, on the
CPU: the batched rows (mcraw_torch.preview.frame_develop_rows and the
batched white-point solve in mcraw_torch.color) against the per-frame
math, the per-frame develop against single calls and the f64 model,
multiview playback (preview_clips) against decode_clips, and the
benchmark's multiview mode with its controls at a small size."""

import dataclasses

import numpy as np
import pytest
import torch

from mcraw_torch import Decoder, observe
from mcraw_torch import color as C
from mcraw_torch import encode as E
from mcraw_torch import preview as P
from mcraw_torch.kernels import develop as D
from mcraw_torch.metadata import (
    CFA_PATTERNS,
    ContainerMetadata,
    FrameMetadata,
    example_container_metadata,
    example_frame_metadata,
)
from mcraw_torch.parallel import decode_clips

SENSORS = tuple(CFA_PATTERNS)
MODES = ("bilinear", "malvar")
CM1 = np.array([0.7188, -0.1641, -0.0791, -0.4609, 1.2578, 0.2266, -0.0859, 0.2031, 0.6094])
CM2 = np.array([1.0938, -0.5234, -0.0273, -0.3750, 1.1563, 0.2461, -0.0195, 0.1133, 0.5547])
FM1 = np.array([0.6953, 0.1680, 0.1016, 0.2813, 0.8359, -0.1172, 0.0273, -0.2422, 1.0391])
FM2 = np.array([0.6445, 0.1289, 0.1914, 0.2344, 0.7813, -0.0156, 0.0195, -0.3906, 1.1953])
# As-shot neutrals: warm and cool ones inside the calibration range, and
# ones far beyond tungsten and beyond daylight (both weight clamps).
NEUTRALS = ([0.62, 1.0, 0.55], [0.45, 1.0, 0.78], [1.6, 1.0, 0.12], [0.25, 1.0, 1.9])


def container(k: int, sensor: str, two_sets: bool = True) -> dict:
    """Clip k's container metadata: its own levels and matrices."""
    rng = np.random.default_rng(k)
    cm = example_container_metadata(sensor=sensor, white_level=4095.0,
                                    black_level=tuple(int(b) for b in rng.integers(56, 73, 4)))
    vary = 1 + rng.normal(0, 0.02, (4, 9))
    cm.update(colorMatrix1=(CM1 * vary[0]).tolist(), colorMatrix2=(CM2 * vary[1]).tolist(),
              forwardMatrix1=(FM1 * vary[2]).tolist(), forwardMatrix2=(FM2 * vary[3]).tolist())
    if not two_sets:
        del cm["colorMatrix2"], cm["forwardMatrix2"]
    return cm


def frame(w: int, h: int, neutral) -> dict:
    fm = example_frame_metadata(w, h)
    fm["asShotNeutral"] = [float(v) for v in neutral]
    return fm


def per_frame_row(cm: dict, fm: dict) -> np.ndarray:
    """The row a single-frame develop packs: _frame_rgba's arguments."""
    c, f = ContainerMetadata(cm), FrameMetadata(fm)
    fwd, _, _ = C.interpolated_matrices(c, f.as_shot_neutral)
    return D.pack_develop_params(np.asarray(c.black_level), np.asarray(np.float32(c.white_level)),
                                 np.asarray(f.as_shot_neutral), fwd.astype(np.float32))[0]


@pytest.mark.parametrize("two_sets", [True, False])
@pytest.mark.parametrize("neutrals", [NEUTRALS, NEUTRALS[::-1] + NEUTRALS[:1]])
def test_frame_develop_rows_equal_the_per_frame_rows(neutrals, two_sets):
    cms = [container(k, SENSORS[k % 4], two_sets) for k in range(len(neutrals))]
    fms = [frame(16, 8, n) for n in neutrals]
    rows = P.frame_develop_rows(cms, fms)
    assert rows.rows.dtype == torch.float32 and rows.rows.shape == (len(neutrals), 128)
    for k, (cm, fm) in enumerate(zip(cms, fms)):
        want = per_frame_row(cm, fm)
        assert np.array_equal(rows.rows[k].numpy().view(np.int32), want.view(np.int32))
        assert tuple(rows.cfas[k].tolist()) == tuple(CFA_PATTERNS[cm["sensorArrangment"]])


def test_frame_develop_rows_solve_every_white_point_in_one_batch():
    """One call solves the white point of each two-set frame (a clip's
    metadata given once or repeated), none of a single-illuminant clip's,
    and keeps nothing: a second call solves them again. A step's slice of
    a shot's rows is the step's own call's rows."""
    cms = [container(100 + k, SENSORS[k]) for k in range(4)]
    fms = [frame(16, 8, [0.5 + 0.0101 * k, 1.0, 0.61]) for k in range(8)]
    shot = cms + cms  # two ticks of the four clips
    for _ in range(2):
        with observe.tracing() as rec:
            rows = P.frame_develop_rows(shot, fms)
        assert rec.counters["color.white_solves"] == 8
        assert rec.summary()["spans"]["develop.frame_params"]["count"] == 1
    step = P.frame_develop_rows([ContainerMetadata(dict(c)) for c in cms],
                                [FrameMetadata(dict(f)) for f in fms[4:]])
    tick = rows.frames(4, 8)
    assert torch.equal(tick.rows, step.rows) and torch.equal(tick.cfas, step.cfas)
    with observe.tracing() as rec:
        P.frame_develop_rows(cms[:1] + [container(7, "rggb", two_sets=False)],
                             [frame(16, 8, [0.4321, 1.0, 0.5]), fms[0]])
    assert rec.counters["color.white_solves"] == 1


def test_batched_white_points_equal_the_scalar_ones():
    rng = np.random.default_rng(17)
    n = 64
    cm1 = np.eye(3) * rng.uniform(0.5, 1.5, (n, 1, 1)) + rng.normal(0, 0.1, (n, 3, 3))
    cm2 = np.eye(3) * rng.uniform(0.5, 1.5, (n, 1, 1)) + rng.normal(0, 0.1, (n, 3, 3))
    fm1, fm2 = rng.normal(0, 0.3, (2, n, 3, 3)) + np.eye(3)
    neutrals = rng.uniform(0.1, 2.0, (n, 3))
    neutrals[:4] = NEUTRALS
    xy = C.neutral_to_xy_batch(neutrals, cm1, cm2)
    fwd = C.interpolated_forward_batch(neutrals, cm1, cm2, fm1, fm2)
    for k in range(n):
        want = C.neutral_to_xy(neutrals[k], cm1[k], cm2[k])
        assert xy[k, 0] == want[0] and xy[k, 1] == want[1]
        g = C._interp_weight(C.cct_from_xy(want))
        assert np.array_equal(fwd[k], g * fm1[k] + (1.0 - g) * fm2[k])
    singular = np.zeros((1, 3, 3))
    assert np.array_equal(C.neutral_to_xy_batch(neutrals[:1], singular, singular)[0],
                          C.neutral_to_xy(neutrals[0], singular[0], singular[0]))


def test_reference_color_agrees_with_the_program():
    """gpubench's float64 DNG math, written from the specification, within
    1e-12 of the program's: the white point, the weight and the forward
    matrix, the clamps included."""
    from gpubench.ref import color as RC

    rng = np.random.default_rng(23)
    for k in range(40):
        cm = ContainerMetadata(container(k, "rggb"))
        neutral = NEUTRALS[k % 4] if k < 8 else [rng.uniform(0.2, 1.5), 1.0,
                                                 rng.uniform(0.2, 1.5)]
        mats = [np.asarray(m, np.float64) for m in (cm.color_matrix(1), cm.color_matrix(2),
                                                    cm.forward_matrix(1), cm.forward_matrix(2))]
        fwd, _, g = C.interpolated_matrices(cm, neutral)
        xy = C.neutral_to_xy(neutral, mats[0], mats[1])
        assert np.abs(RC.white_point(neutral, mats[0], mats[1]) - xy).max() < 1e-12
        ref_fwd, ref_g = RC.forward_matrix(neutral, *mats)
        assert abs(ref_g - g) < 1e-12 and np.abs(ref_fwd - fwd).max() < 1e-12


@pytest.mark.parametrize("demosaic", MODES)
@pytest.mark.parametrize("h, w", [(9, 14), (12, 24)])
def test_develop_frames_rgba_equals_single_calls_and_the_model(h, w, demosaic):
    """Four frames, the four CFAs, each its own clip's and frame's
    metadata, in one call: bit for bit one call a frame, within 1 LSB of
    the f64 model at each frame's interpolated matrices."""
    rng = np.random.default_rng(h * w)
    raw = rng.integers(0, 4096, size=(4, h, w), dtype=np.uint16)
    cms = [container(k, SENSORS[k]) for k in range(4)]
    fms = [frame(w, h, NEUTRALS[k]) for k in range(4)]
    rows = P.frame_develop_rows(cms, fms)
    got = P.develop_frames_rgba(torch.from_numpy(raw), rows.rows, rows.cfas, demosaic=demosaic)
    for k, (cm, fm) in enumerate(zip(cms, fms)):
        c, f = ContainerMetadata(cm), FrameMetadata(fm)
        one = P._frame_rgba(torch.from_numpy(raw[k]), f, c, tuple(c.cfa_pattern), demosaic)
        assert torch.equal(got[k], one)
        fwd, _, _ = C.interpolated_matrices(c, f.as_shot_neutral)
        model = P.develop_f64(raw[k], c.black_level, np.float32(c.white_level),
                              f.as_shot_neutral, fwd.astype(np.float32), tuple(c.cfa_pattern),
                              demosaic=demosaic)
        codes = got[k].to(torch.int64).numpy()
        for i, s in enumerate((0, 8, 16)):
            assert np.abs(((codes >> s) & 0xFF) - model[..., i]).max() <= 1


def clip_blob(k: int, sensor: str, images, neutrals) -> bytes:
    writer = E.ContainerWriter(container(k, sensor))
    for i, (img, n) in enumerate(zip(images, neutrals)):
        writer.add_frame(100 + i, E.encode_modern(img), frame(img.shape[1], img.shape[0], n))
    return writer.finish()


@pytest.fixture(scope="module")
def clips():
    """Four modern clips of 3 frames, 16x64, each its own CFA, levels,
    matrices and drifting neutral."""
    rng = np.random.default_rng(31)
    out = []
    for k in range(4):
        images = [rng.integers(0, 4096, size=(16, 64), dtype=np.uint16) for _ in range(3)]
        neutrals = [[0.5 + 0.05 * k + 0.1 * t, 1.0, 0.8 - 0.1 * t] for t in range(3)]
        out.append(clip_blob(k, SENSORS[k], images, neutrals))
    return out


@pytest.mark.parametrize("demosaic", MODES)
def test_preview_clips_equals_decode_clips_then_per_frame_develops(clips, demosaic):
    decoders = [Decoder(b, device="cpu") for b in clips]
    planes, metas = decode_clips(decoders)
    with observe.tracing() as rec:
        ticks = list(P.preview_clips(decoders, demosaic=demosaic))
    assert rec.counters["color.white_solves"] == 12  # every frame's, once, at the start
    assert rec.summary()["spans"]["develop.frame_params"]["count"] == 1
    assert rec.counters["develop.frame_rows"] == 12
    assert [ts for ts, _ in ticks] == [list(t) for t in zip(*[d.frames for d in decoders])]
    for t, (_, rgba) in enumerate(ticks):
        assert rgba.shape == (4, 16, 64) and rgba.dtype == torch.uint32
        for c, d in enumerate(decoders):
            cm = ContainerMetadata(d.container_metadata)
            want = P._frame_rgba(planes[c, t], FrameMetadata(metas[c][t]), cm,
                                 tuple(cm.cfa_pattern), demosaic)
            assert torch.equal(rgba[c], want)


def test_preview_clips_rejects_what_decode_clips_rejects(clips):
    rng = np.random.default_rng(5)
    legacy = E.ContainerWriter(container(9, "rggb"))
    wide = E.ContainerWriter(container(9, "rggb"))
    for i in range(3):
        img = rng.integers(0, 4096, size=(16, 64), dtype=np.uint16)
        legacy.add_frame(100 + i, E.encode_legacy(img), frame(64, 16, NEUTRALS[0]) | {
            "compressionType": 6})
        img = rng.integers(0, 4096, size=(16, 128), dtype=np.uint16)
        wide.add_frame(100 + i, E.encode_modern(img), frame(128, 16, NEUTRALS[0]))
    d = [Decoder(b, device="cpu") for b in clips[:2]]
    for other, text in ((legacy.finish(), "mixed codecs"), (wide.finish(), "geometry")):
        with pytest.raises(ValueError, match=text):
            next(iter(P.preview_clips(d + [Decoder(other, device="cpu")])))
    with pytest.raises(ValueError, match="equal frame counts"):
        P.preview_clips(d, [d[0].frames, d[1].frames[:2]])


@pytest.mark.parametrize("demosaic", MODES)
def test_preview_clip_develops_a_batch_in_one_call_as_frame_by_frame(clips, demosaic):
    """preview_clip develops each batch with a row for each frame: the same
    RGBA as developing frame by frame, each frame's neutral its own."""
    d = Decoder(clips[1], device="cpu")
    cm = ContainerMetadata(d.container_metadata)
    with observe.tracing() as rec:
        got = list(P.preview_clip(d, batch_frames=2, demosaic=demosaic))
    assert rec.counters["develop.frame_rows"] == 3
    assert [t for t, _ in got] == d.frames
    for t, rgba in got:
        img, meta = d.load_frame_device(t)
        want = P._frame_rgba(img, FrameMetadata(meta), cm, tuple(cm.cfa_pattern), demosaic)
        assert torch.equal(rgba, want)


# -- the benchmark's multiview mode, at a small size ---------------------------


def small_multiview(height: int = 24, width: int = 192, ticks: int = 3):
    from gpubench import spec

    cell = spec.load("modern-multiview-grade")
    return dataclasses.replace(
        cell, config=dict(cell.config, height=height, width=width, ticks_per_clip=ticks),
        traffic=dict(cell.traffic, distinct_frames=3, frames=8 * ticks, trace_seconds=0.2))


@pytest.fixture
def sampled_ticks():
    """sampled_ticks(): three ticks of the small multiview shot through the
    mode's loop on the CPU, each kept, with their grades, the reference and
    the cell: what the check takes, whatever the host's speed."""
    from gpubench import check, resident, run
    from gpubench import multiview as MV
    from gpubench.trace import Spans

    def go(seed: int = 2**31 + 19):
        cell = small_multiview()
        encoding = run.Encoding(cell, seed, 1)
        try:
            inputs = run.make_inputs(cell, seed, encoding)
        finally:
            encoding.close(stop=True)
        shoot = MV.Shoot(inputs, cell.config, cell.traffic, torch.device("cpu"), seed)
        shoot.make_rows()
        res = resident.Loop(shoot, Spans()).run(None, steps=3, keep_at=[0.0, 0.0, 0.0])
        ref = check.Reference(inputs.payloads, cell.config, torch.device("cpu"))
        return shoot.sampled(res["kept"]), ref, cell

    return go


def test_multiview_check_holds_the_program_and_refuses_both_controls(sampled_ticks):
    from gpubench import multiview as MV

    kept, ref, cell = sampled_ticks()
    assert [frames.tick for frames, *_ in kept] == [0, 1, 2]
    checks = MV.frame_checks(kept, ref, cell.config, "bilinear")
    assert checks.correct and checks.rows["unchecked"][0] == 0, checks.line()
    for name, kw in MV.CONTROLS.items():
        control = MV.frame_checks(kept, ref, cell.config, "bilinear", **kw)
        assert not control.correct, (name, control.line())
    first_row = MV.frame_checks(kept, ref, cell.config, "bilinear", first_row=True)
    assert first_row.rows["plane_mismatch"][0] == 0


def test_multiview_check_refuses_a_program_that_reads_one_row_a_tick(sampled_ticks,
                                                                     monkeypatch):
    """A program that develops every frame of a tick with the tick's first
    row and CFA is not correct."""
    from gpubench import multiview as MV

    develop = P.develop_frames_rgba

    def first_row(planes, rows, cfas, demosaic="bilinear"):
        return develop(planes, rows[:1].expand(len(rows), -1), cfas[:1].expand(len(cfas), -1),
                       demosaic=demosaic)

    monkeypatch.setattr(P, "develop_frames_rgba", first_row)
    kept, ref, cell = sampled_ticks()
    assert not MV.frame_checks(kept, ref, cell.config, "bilinear").correct


def test_multiview_run_reports_its_metrics_and_checks(monkeypatch, tmp_path):
    """One traced run of the small cell end to end: the host span's metric
    (no device kernels on the CPU) and every compared number within its
    limit but `unchecked`, which a loaded host may leave at 1 (its window
    may end before a sampled time)."""
    from gpubench import run

    monkeypatch.setattr(run, "RUNS", tmp_path)
    out = run.run_cell(small_multiview(), 2**31 + 23, 1.0, True, torch.device("cpu"),
                       workers=1, t_start=0.0)
    result = out["result"]
    assert result["metrics"]["params_ms.multiview"]["value"] > 0
    assert all(c["value"] <= c["limit"] for name, c in result["checks"].items()
               if name != "unchecked"), result["checks"]


def test_multiview_mode_raises_at_once_without_the_per_frame_develop(monkeypatch, tmp_path):
    from gpubench import run

    monkeypatch.setattr(run, "RUNS", tmp_path)
    monkeypatch.delattr(P, "frame_develop_rows")
    with pytest.raises(RuntimeError, match="per-frame develop"):
        run.run_cell(small_multiview(), 2**31 + 29, 1.0, False, torch.device("cpu"),
                     workers=1, t_start=0.0)


def test_multiview_neutrals_drift_across_the_clamps():
    """The configuration's drift takes every angle's weight from the
    tungsten clamp (0) to the daylight clamp (1), and every seed flickers
    its own way within 0.5 %."""
    from gpubench import multiview as MV
    from gpubench import spec
    from gpubench.ref import color as RC

    cell = spec.load("modern-multiview-grade")
    a = MV.neutrals(cell.config, cell.traffic, 7)
    b = MV.neutrals(cell.config, cell.traffic, 8)
    assert a.shape == (120, 8, 3) and not np.array_equal(a, b)
    assert np.all(a[..., 1] == 1.0)
    for k, angle in enumerate(cell.config["angles"]):
        mats = [MV.container_json(angle)[m] for m in ("colorMatrix1", "colorMatrix2",
                                                     "forwardMatrix1", "forwardMatrix2")]
        weights = [RC.forward_matrix(a[t, k], *mats)[1] for t in (0, 60, 119)]
        assert weights[0] == 0.0 and weights[2] == 1.0 and 0.0 < weights[1] < 1.0
