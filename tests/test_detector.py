"""Detection pipeline tests: dictionary bit-exactness vs OpenCV, rendered
frame detection vs ground truth and vs cv2.aruco (SURVEY.md section 4.1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aruco_slam_tpu.ops import detector, dictionary
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import renderer, synthetic

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)


def test_dictionary_matches_opencv_bytes():
    cv2 = pytest.importorskip("cv2")
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_ARUCO_ORIGINAL)
    ours = dictionary.aruco_original_bits()
    rots = dictionary.aruco_original_rotations()

    def unpack(b4):
        bits = np.unpackbits(b4[:3].astype(np.uint8))
        return np.concatenate([bits, [b4[3] & 1]]).reshape(5, 5)

    rng = np.random.default_rng(0)
    for mid in rng.choice(1024, size=64, replace=False):
        np.testing.assert_array_equal(unpack(d.bytesList[mid][0]), ours[mid])
        for r in range(4):
            np.testing.assert_array_equal(
                unpack(d.bytesList[mid][r]), rots[r, mid].reshape(5, 5)
            )


def test_match_bits_identifies_rotations():
    # note: some ARUCO_ORIGINAL codewords are rotationally symmetric (e.g.
    # id 1023 = all rows 01110 is 180-degree symmetric), so use asymmetric ids.
    bits = dictionary.aruco_original_bits()
    for mid in (0, 7, 512, 800):
        for r in range(4):
            rotated = np.rot90(bits[mid], r)
            got_id, got_rot, dist, ok = dictionary.match_bits(
                jnp.asarray(rotated)
            )
            assert int(got_id) == mid
            assert int(got_rot) == r
            assert float(dist) == 0.0
            assert bool(ok)


def test_match_bits_error_correction():
    bits = dictionary.aruco_original_bits()[42].copy()
    bits[2, 2] ^= 1  # flip one bit
    got_id, _, dist, ok = dictionary.match_bits(jnp.asarray(bits), max_correction=1)
    assert int(got_id) == 42 and float(dist) == 1.0 and bool(ok)
    # two flips (min distance 2 from every codeword) must be rejected
    bad = dictionary.aruco_original_bits()[42].copy()
    bad[0, 1] ^= 1
    bad[0, 3] ^= 1
    _, _, dist, ok = dictionary.match_bits(jnp.asarray(bad), max_correction=1)
    assert float(dist) == 2.0 and not bool(ok)


def _render_scene(pose=(2.55, -2.0, 1.2), n_markers=20):
    arena = synthetic.make_arena(n_markers=n_markers)
    stack = renderer.build_marker_stack(arena)
    cam_pos, R_wc = renderer.camera_pose_from_robot(
        jnp.asarray(pose, jnp.float32)
    )
    img = renderer.render_frame(cam_pos, R_wc, stack, CAM)
    return np.asarray(img), arena, np.asarray(cam_pos), np.asarray(R_wc)


def _true_visible(arena, cam_pos, R_wc, max_dist=3.5):
    """Ground-truth visible marker ids + projected corners."""
    from aruco_slam_tpu.ops.camera import project_points
    from aruco_slam_tpu.ops.pnp import marker_object_points
    from aruco_slam_tpu.sim.synthetic import rpy_matrix_np

    out = {}
    for i in range(len(arena)):
        R_wm = rpy_matrix_np(*arena.rpys[i])
        obj = np.asarray(marker_object_points(float(arena.lengths[i])))
        world = obj @ R_wm.T + arena.positions[i]
        cam = (world - cam_pos) @ R_wc
        if np.any(cam[:, 2] < 0.2):
            continue
        # facing check
        n_c = R_wc.T @ (R_wm @ np.array([0, 0, 1.0]))
        if n_c[2] > -0.3:
            continue
        px = np.asarray(project_points(jnp.asarray(cam, jnp.float32), CAM))
        if px[:, 0].min() < 5 or px[:, 0].max() > 635:
            continue
        if px[:, 1].min() < 5 or px[:, 1].max() > 475:
            continue
        if np.linalg.norm(cam.mean(axis=0)) > max_dist:
            continue
        out[int(arena.ids[i])] = px
    return out


def test_detect_rendered_markers():
    img, arena, cam_pos, R_wc = _render_scene()
    expected = _true_visible(arena, cam_pos, R_wc)
    assert len(expected) >= 2, "scene should contain visible markers"
    det = jax.jit(detector.detect_markers, static_argnums=1)(
        jnp.asarray(img), detector.DetectorConfig()
    )
    ids = np.asarray(det.ids)
    valid = np.asarray(det.valid)
    found = {int(i) for i in ids[valid]}
    assert set(expected).issubset(found), (set(expected), found)
    # corner accuracy: blob-extreme corners are pixel-quantized; allow 2 px
    for k in range(len(ids)):
        if valid[k] and int(ids[k]) in expected:
            got = np.asarray(det.corners)[k]
            ref = expected[int(ids[k])]
            err = np.abs(got - ref).max()
            assert err < 2.5, (ids[k], err, got, ref)


def test_detect_matches_opencv_ids():
    cv2 = pytest.importorskip("cv2")
    img, arena, cam_pos, R_wc = _render_scene(pose=(2.0, -2.5, 2.5))
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_ARUCO_ORIGINAL)
    params = cv2.aruco.DetectorParameters()
    cv_det = cv2.aruco.ArucoDetector(d, params)
    cv_corners, cv_ids, _ = cv_det.detectMarkers(img)
    cv_found = set() if cv_ids is None else {int(i) for i in cv_ids.ravel()}
    det = detector.detect_markers(jnp.asarray(img))
    ours = {int(i) for i in np.asarray(det.ids)[np.asarray(det.valid)]}
    # We must find at least everything OpenCV finds on our clean renders
    assert cv_found.issubset(ours), (cv_found, ours)
    # and corner agreement within ~2.5 px for shared ids
    if cv_ids is not None:
        for c, i in zip(cv_corners, cv_ids.ravel()):
            k = list(np.asarray(det.ids)).index(int(i))
            err = np.abs(np.asarray(det.corners)[k] - c[0]).max()
            assert err < 3.0, (i, err)


def test_empty_image_no_detections():
    img = jnp.full((240, 320), 178, jnp.uint8)
    det = detector.detect_markers(img)
    assert not bool(np.any(np.asarray(det.valid)))


def test_to_grayscale_matches_opencv_coefficients():
    """BGR luma (Y = 0.299R + 0.587G + 0.114B) with cv2-style rounding."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 24, 3), np.uint8)
    y = np.asarray(detector.to_grayscale(jnp.asarray(img)))
    ref = np.round(
        0.114 * img[..., 0].astype(np.float64)
        + 0.587 * img[..., 1]
        + 0.299 * img[..., 2]
    )
    np.testing.assert_allclose(y.astype(np.float64), ref, atol=1.0)
    # rgb order flips the weights
    y_rgb = np.asarray(detector.to_grayscale(jnp.asarray(img), "rgb"))
    ref_rgb = np.round(0.299 * img[..., 0].astype(np.float64)
                       + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    np.testing.assert_allclose(y_rgb.astype(np.float64), ref_rgb, atol=1.0)


def test_detect_color_frame_matches_grayscale():
    """A bgr8 frame must detect identically to its grayscale twin — the
    reference ingests color (cv_bridge 'bgr8', src/aruco_slam_node.cpp:93)
    and OpenCV grayscales internally."""
    img, *_ = _render_scene()
    color = np.stack([img] * 3, axis=-1)  # gray replicated -> exact luma
    det_g = detector.detect_markers(jnp.asarray(img))
    det_c = detector.detect_markers(jnp.asarray(color))
    np.testing.assert_array_equal(np.asarray(det_g.ids), np.asarray(det_c.ids))
    np.testing.assert_array_equal(
        np.asarray(det_g.valid), np.asarray(det_c.valid)
    )
    np.testing.assert_allclose(
        np.asarray(det_g.corners), np.asarray(det_c.corners), atol=1e-5
    )
    assert bool(np.any(np.asarray(det_g.valid)))
    # detect_frames accepts the color stack too
    from aruco_slam_tpu import runner

    ids_f, corners_f, valid_f = runner.detect_frames(
        jnp.asarray(color)[None], chunk=1
    )
    np.testing.assert_array_equal(np.asarray(ids_f[0]), np.asarray(det_g.ids))


def test_batch_detection_shapes():
    img, *_ = _render_scene()
    batch = jnp.stack([jnp.asarray(img)] * 2)
    det = detector.detect_markers_batch(batch, detector.DetectorConfig())
    assert det.ids.shape[0] == 2
    assert det.corners.shape == (2, detector.DetectorConfig().max_candidates, 4, 2)
    np.testing.assert_array_equal(np.asarray(det.ids[0]), np.asarray(det.ids[1]))


def test_multiscale_sweep_no_duplicates():
    """adaptive_radii sweep must find the same markers exactly once each
    (per-id dedup across scales)."""
    img, arena, cam_pos, R_wc = _render_scene()
    single = detector.detect_markers(jnp.asarray(img), detector.DetectorConfig())
    multi = detector.detect_markers(
        jnp.asarray(img), detector.DetectorConfig(adaptive_radii=(3, 7, 13))
    )
    ids_s = sorted(int(i) for i in np.asarray(single.ids)[np.asarray(single.valid)])
    ids_m = [int(i) for i in np.asarray(multi.ids)[np.asarray(multi.valid)]]
    assert sorted(ids_m) == sorted(set(ids_m)), "duplicate ids"
    assert set(ids_s).issubset(set(ids_m))


def test_ccl_matches_scipy_oracle():
    """Scan-accelerated CCL must agree with scipy.ndimage 8-connected
    labeling (labels constant within each component, distinct across) on
    rendered marker scenes and random blob masks."""
    ndimage = pytest.importorskip("scipy.ndimage")
    # The CCL primitive's general contract is 8 rounds (serpentine blobs
    # split at 5); the detector's own default is 4, enough for marker
    # scenes — this test exercises the primitive, so pin 8.
    cfg = detector.DetectorConfig(ccl_rounds=8)
    masks = []
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=1.0, seed=3), level="images", camera=CAM
    )
    for i in (0, 5, 9):
        img = jnp.asarray(np.asarray(seq.images)[i])
        masks.append(np.asarray(detector.adaptive_threshold(
            img, cfg.adaptive_radius, cfg.adaptive_C)))
    rng = np.random.default_rng(1)
    masks.append(ndimage.binary_dilation(
        rng.random((480, 640)) > 0.995, iterations=6))
    f = jax.jit(lambda m: detector.label_components(m, cfg.ccl_rounds))
    for fg in masks:
        labels = np.asarray(f(jnp.asarray(fg))).reshape(fg.shape)
        ref, nref = ndimage.label(fg, structure=np.ones((3, 3), bool))
        seen = set()
        for comp in range(1, nref + 1):
            vals = np.unique(labels[ref == comp])
            assert len(vals) == 1, f"component {comp} split: {vals[:5]}"
            assert vals[0] not in seen, f"label reused across components"
            seen.add(vals[0])
        # background keeps its own flat index
        flat_idx = np.arange(fg.size).reshape(fg.shape)
        np.testing.assert_array_equal(labels[~fg], flat_idx[~fg])


def test_extract_quads_tall_narrow_trapezoid():
    """Round-2 regression: on tall-narrow (shallow-view) quads the farthest
    point from one corner is an ADJACENT corner, which collapsed the old
    farthest-from-p0 corner chain (missed marker id 6 in the parity sweep's
    shallow2 scene). The diagonal-scored chain must recover all 4 corners."""
    import numpy as np

    h, w = 480, 640
    quad = np.array([[133, 170], [182, 183], [182, 297], [134, 310]], float)
    yy, xx = np.mgrid[0:h, 0:w]

    def inside(q):
        m = np.ones((h, w), bool)
        for i in range(4):
            a, b = q[i], q[(i + 1) % 4]
            cross = (b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0])
            m &= cross >= 0
        return m

    fg = jnp.asarray(inside(quad))
    cfg = detector.DetectorConfig()
    labels = detector.label_components(fg, cfg.ccl_rounds)
    corners, valid = detector.extract_quads(labels, fg, cfg)
    corners = np.asarray(corners)[np.asarray(valid)]
    assert len(corners) == 1, len(corners)
    got = corners[0]
    # each true corner matched within a few px (subsampled bbox margin)
    for q in quad:
        d = np.min(np.linalg.norm(got - q, axis=1))
        assert d < 5.0, (q, got)


def test_extract_quads_roots_in_same_stats_cell():
    """Round-3 regression (ADVICE round 2): two components whose ROOT
    pixels (min flat index) land in the same stats_stride grid cell used
    to merge stats under the grid-cell key — root_lab took the min and the
    other component silently lost candidacy. Stats are now keyed by the
    exact root index, so both must survive."""
    import numpy as np

    h, w = 480, 640
    fg = np.zeros((h, w), bool)
    # Two vertical bars, 8-disconnected (gap at col 42), with roots at
    # (48, 40) and (50, 43) — both in stride-4 cell (12, 10).
    fg[48:121, 40:42] = True
    fg[50:123, 43:45] = True
    cfg = detector.DetectorConfig()
    labels = detector.label_components(jnp.asarray(fg), cfg.ccl_rounds)
    corners, valid = detector.extract_quads(labels, jnp.asarray(fg), cfg)
    corners = np.asarray(corners)[np.asarray(valid)]
    assert len(corners) == 2, len(corners)
    # one candidate per bar (distinguish by x-range)
    mean_x = np.sort(corners.mean(axis=1)[:, 0])
    assert abs(mean_x[0] - 40.5) < 2.5 and abs(mean_x[1] - 43.5) < 2.5, mean_x


def test_second_chance_preserves_pass1_winners():
    """The budgeted retry decode may only FILL pass-1 misses: on a clean
    scene (every candidate decodes on pass 1) detections must be
    bit-identical with the retry on or off."""
    import dataclasses

    img, _, _, _ = _render_scene()
    on = detector.detect_markers(
        jnp.asarray(img), detector.DetectorConfig()
    )
    off = detector.detect_markers(
        jnp.asarray(img),
        dataclasses.replace(detector.DetectorConfig(), second_chance=False),
    )
    np.testing.assert_array_equal(np.asarray(on.ids), np.asarray(off.ids))
    np.testing.assert_array_equal(
        np.asarray(on.valid), np.asarray(off.valid)
    )
    np.testing.assert_array_equal(
        np.asarray(on.corners), np.asarray(off.corners)
    )


def test_closed_budget_compaction_preserves_detections():
    """The stats-level closed-source pre-dedup + 8-slot compaction must
    not change what is detected on marker scenes (closed candidates that
    survive it are fragment merges / genuinely new blobs; on a healthy
    scene every closed candidate duplicates a raw one)."""
    import dataclasses

    img, _, _, _ = _render_scene()
    budget = detector.detect_markers(
        jnp.asarray(img), detector.DetectorConfig()
    )
    full = detector.detect_markers(
        jnp.asarray(img),
        dataclasses.replace(detector.DetectorConfig(), closed_budget=0),
    )
    ids_b = set(np.asarray(budget.ids)[np.asarray(budget.valid)].tolist())
    ids_f = set(np.asarray(full.ids)[np.asarray(full.valid)].tolist())
    assert ids_b == ids_f


def test_seeded_closed_ccl_converges_on_markers():
    """The seeded 2-round closed labeling must equal the from-scratch
    fixed point on a rendered marker scene (the production case the trip
    count was chosen for; random blobs can legitimately need more)."""
    cam = CAM
    arena = synthetic.make_arena(n_markers=20)
    stack = renderer.build_marker_stack(arena)
    cam_pos, R_wc = renderer.camera_pose_from_robot(
        jnp.asarray((2.55, -2.0, 1.2), jnp.float32)
    )
    img = renderer.render_frame(cam_pos, R_wc, stack, cam)
    cfg = detector.DetectorConfig()
    fg = detector.adaptive_threshold(
        img, cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride
    )
    lab = detector.label_components(fg, cfg.ccl_rounds)
    fgc = detector.binary_close3(fg)
    seeded = detector.label_components(
        fgc, cfg.closed_ccl_rounds, init=lab.reshape(fg.shape)
    )
    full = detector.label_components(fgc, 8)  # fixed point reference
    assert jnp.array_equal(seeded, full)


@pytest.mark.parametrize("shape", [(480, 640), (720, 1280), (1080, 1920)])
def test_ccl_matches_scipy_oracle_bucket_shapes(shape):
    """label_components at each stock shape bucket (DetectorConfig.
    shape_buckets) agrees with scipy.ndimage 8-connected labeling on a
    random blob mask: one label per component, distinct across, and
    background keeping its own flat index."""
    ndimage = pytest.importorskip("scipy.ndimage")
    rng = np.random.default_rng(shape[0])
    fg = ndimage.binary_dilation(rng.random(shape) > 0.9993, iterations=5)
    labels = np.asarray(
        jax.jit(lambda m: detector.label_components(m, 8))(jnp.asarray(fg))
    ).reshape(shape)
    ref, nref = ndimage.label(fg, structure=np.ones((3, 3), bool))
    assert nref > 10
    per_comp = [np.unique(labels[ref == c]) for c in range(1, nref + 1)]
    assert all(len(v) == 1 for v in per_comp)
    assert len({int(v[0]) for v in per_comp}) == nref
    flat_idx = np.arange(fg.size).reshape(shape)
    np.testing.assert_array_equal(labels[~fg], flat_idx[~fg])


def _close3_oracle(fg):
    """3x3 closing with the detector's border convention: outside the
    image is background for the dilation and foreground for the erosion."""
    from scipy import ndimage

    st = np.ones((3, 3), bool)
    dil = ndimage.binary_dilation(fg, structure=st, border_value=0)
    return ndimage.binary_erosion(dil, structure=st, border_value=1)


@pytest.mark.parametrize(
    "case", ["corner_pixel", "edge_line", "gap_at_border", "random"]
)
def test_binary_close3_border_cases(case):
    """binary_close3 at the frame border: content touching the edge is
    neither grown past it nor eaten by it, and a 1-px gap next to the
    border is bridged like one in the interior."""
    pytest.importorskip("scipy.ndimage")
    fg = np.zeros((12, 16), bool)
    if case == "corner_pixel":
        fg[0, 0] = True
    elif case == "edge_line":
        fg[:, 0] = True
        fg[5, :] = True
    elif case == "gap_at_border":
        fg[0, :7] = True
        fg[0, 8:] = True
        fg[1, :] = True
    else:
        fg = np.random.default_rng(3).random((12, 16)) < 0.45
    got = np.asarray(detector.binary_close3(jnp.asarray(fg)))
    np.testing.assert_array_equal(got, _close3_oracle(fg))
    assert (got | ~fg).all()  # closing never removes foreground
