"""Camera-path utilities for novel-view rendering & bounding estimation
(counterpart of gaussmart_tpu/trajectory.py).

viewmatrix/focus_point_fn/transform_poses_pca/generate_ellipse_path follow
the published Mip-NeRF 360 ellipse-path algorithm (Google's multinerf,
Apache-2.0), the same third-party-derived math as the JAX package's copy.
Images are saved through io/images.py, videos through io/video.py (the
port's MPEG-4 Part 2 encoder; no OpenCV); depth frames are coloured with a
numpy copy of matplotlib's turbo map.
"""
from __future__ import annotations

from typing import List

import numpy as np

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.io.images import write_png, write_tiff_f32
from gaussmart_tpu_torch.io.video import write_video


def normalize(x):
    return x / np.linalg.norm(x)


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def viewmatrix(lookdir, up, position):
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Nearest point to all camera focal axes."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses: np.ndarray):
    """Align principal axes of camera positions to XYZ."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1, 1, -1]) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag([1, -1, -1]) @ poses_recentered
        transform = np.diag([1, -1, -1, 1]) @ transform
    return np.real(poses_recentered), np.real(transform)


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0, z_phase: float = 0.0):
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2]
                           * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ], -1)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)[:-1]
    avg_up = normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])
    return np.stack([viewmatrix(p - center, up, p) for p in positions])


def cameras_c2w(cameras: List[Camera]) -> np.ndarray:
    """Column-vector camera-to-world matrices for a camera list."""
    return np.array([c.c2w() for c in cameras])


def generate_path(viewpoint_cameras: List[Camera], n_frames: int = 480
                  ) -> List[Camera]:
    """Elliptical novel-view trajectory through the capture
    (render_utils.py:173-194)."""
    c2ws = cameras_c2w(viewpoint_cameras)
    pose = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
    pose_recenter, colmap_to_world = transform_poses_pca(pose)
    new_poses = generate_ellipse_path(pose_recenter, n_frames=n_frames)
    new_poses = np.linalg.inv(colmap_to_world) @ pad_poses(new_poses)

    ref = viewpoint_cameras[0]
    traj = []
    for c2w in new_poses:
        c2w = c2w @ np.diag([1, -1, -1, 1.0])
        w2c = np.linalg.inv(c2w)
        cam = Camera(uid=ref.uid, colmap_id=ref.colmap_id,
                     image_name="traj", R=w2c[:3, :3].T, T=w2c[:3, 3],
                     fovx=ref.fovx, fovy=ref.fovy,
                     width=int(ref.width / 2) * 2,
                     height=int(ref.height / 2) * 2)
        traj.append(cam)
    return traj


def estimate_bounding_sphere(cameras: List[Camera]):
    """(center, radius) from camera focal axes (mesh_utils.py:125-137)."""
    c2ws = cameras_c2w(cameras)
    poses = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
    center = focus_point_fn(poses)
    radius = np.linalg.norm(c2ws[:, :3, 3] - center, axis=-1).min()
    return center, float(radius)


def save_img_u8(img: np.ndarray, path: str):
    write_png(path, np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8))


def save_img_f32(depth: np.ndarray, path: str):
    write_tiff_f32(path, np.asarray(depth).astype(np.float32))


# matplotlib's "turbo" colormap (matplotlib/_cm_listed.py, _turbo_data):
# its 256 RGB entries times 1e5, six entries per line
_TURBO_E5 = """
18995 7176 23217 19483 8339 26149 19956 9498 29024 20415 10652 31844 20860 11802 34607 21291 12947 37314
21708 14087 39964 22111 15223 42558 22500 16354 45096 22875 17481 47578 23236 18603 50004 23582 19720 52373
23915 20833 54686 24234 21941 56942 24539 23044 59142 24830 24143 61286 25107 25237 63374 25369 26327 65406
25618 27412 67381 25853 28492 69300 26074 29568 71162 26280 30639 72968 26473 31706 74718 26652 32768 76412
26816 33825 78050 26967 34878 79631 27103 35926 81156 27226 36970 82624 27334 38008 84037 27429 39043 85393
27509 40072 86692 27576 41097 87936 27628 42118 89123 27667 43134 90254 27691 44145 91328 27701 45152 92347
27698 46153 93309 27680 47151 94214 27648 48144 95064 27603 49132 95857 27543 50115 96594 27469 51094 97275
27381 52069 97899 27273 53040 98461 27106 54015 98930 26878 54995 99303 26592 55979 99583 26252 56967 99773
25862 57958 99876 25425 58950 99896 24946 59943 99835 24427 60937 99697 23874 61931 99485 23288 62923 99202
22676 63913 98851 22039 64901 98436 21382 65886 97959 20708 66866 97423 20021 67842 96833 19326 68812 96190
18625 69775 95498 17923 70732 94761 17223 71680 93981 16529 72620 93161 15844 73551 92305 15173 74472 91416
14519 75381 90496 13886 76279 89550 13278 77165 88580 12698 78037 87590 12151 78896 86581 11639 79740 85559
11167 80569 84525 10738 81381 83484 10357 82177 82437 10026 82955 81389 9750 83714 80342 9532 84455 79299
9377 85175 78264 9287 85875 77240 9267 86554 76230 9320 87211 75237 9451 87844 74265 9662 88454 73316
9958 89040 72393 10342 89600 71500 10815 90142 70599 11374 90673 69651 12014 91193 68660 12733 91701 67627
13526 92197 66556 14391 92680 65448 15323 93151 64308 16319 93609 63137 17377 94053 61938 18491 94484 60713
19659 94901 59466 20877 95304 58199 22142 95692 56914 23449 96065 55614 24797 96423 54303 26180 96765 52981
27597 97092 51653 29042 97403 50321 30513 97697 48987 32006 97974 47654 33517 98234 46325 35043 98477 45002
36581 98702 43688 38127 98909 42386 39678 99098 41098 41229 99268 39826 42778 99419 38575 44321 99551 37345
45854 99663 36140 47375 99755 34963 48879 99828 33816 50362 99879 32701 51822 99910 31622 53255 99919 30581
54658 99907 29581 56026 99873 28623 57357 99817 27712 58646 99739 26849 59891 99638 26038 61088 99514 25280
62233 99366 24579 63323 99195 23937 64362 98999 23356 65394 98775 22835 66428 98524 22370 67462 98246 21960
68494 97941 21602 69525 97610 21294 70553 97255 21032 71577 96875 20815 72596 96470 20640 73610 96043 20504
74617 95593 20406 75617 95121 20343 76608 94627 20311 77591 94113 20310 78563 93579 20336 79524 93025 20386
80473 92452 20459 81410 91861 20552 82333 91253 20663 83241 90627 20788 84133 89986 20926 85010 89328 21074
85868 88655 21230 86709 87968 21391 87530 87267 21555 88331 86553 21719 89112 85826 21880 89870 85087 22038
90605 84337 22188 91317 83576 22328 92004 82806 22456 92666 82025 22570 93301 81236 22667 93909 80439 22744
94489 79634 22800 95039 78823 22831 95560 78005 22836 96049 77181 22811 96507 76352 22754 96931 75519 22663
97323 74682 22536 97679 73842 22369 98000 73000 22161 98289 72140 21918 98549 71250 21650 98781 70330 21358
98986 69382 21043 99163 68408 20706 99314 67408 20348 99438 66386 19971 99535 65341 19577 99607 64277 19165
99654 63193 18738 99675 62093 18297 99672 60977 17842 99644 59846 17376 99593 58703 16899 99517 57549 16412
99419 56386 15918 99297 55214 15417 99153 54036 14910 98987 52854 14398 98799 51667 13883 98590 50479 13367
98360 49291 12849 98108 48104 12332 97837 46920 11817 97545 45740 11305 97234 44565 10797 96904 43399 10294
96555 42241 9798 96187 41093 9310 95801 39958 8831 95398 38836 8362 94977 37729 7905 94538 36638 7461
94084 35566 7031 93612 34513 6616 93125 33482 6218 92623 32473 5837 92105 31489 5475 91572 30530 5134
91024 29599 4814 90463 28696 4516 89888 27824 4243 89298 26981 3993 88691 26152 3753 88066 25334 3521
87422 24526 3297 86760 23730 3082 86079 22945 2875 85380 22170 2677 84662 21407 2487 83926 20654 2305
83172 19912 2131 82399 19182 1966 81608 18462 1809 80799 17753 1660 79971 17055 1520 79125 16368 1387
78260 15693 1264 77377 15028 1148 76476 14374 1041 75556 13731 942 74617 13098 851 73661 12477 769
72686 11867 695 71692 11268 629 70680 10680 571 69650 10102 522 68602 9536 481 67535 8980 449
66449 8436 424 65345 7902 408 64223 7380 401 63082 6868 401 61923 6367 410 60746 5878 427
59550 5399 453 58336 4931 486 57103 4474 529 55852 4028 579 54583 3593 638 53295 3169 705
51989 2756 780 50664 2354 863 49321 1963 955 47960 1583 1055
"""
TURBO = np.array(_TURBO_E5.split(), np.int64).reshape(256, 3) / 100000.0


def turbo(x: np.ndarray) -> np.ndarray:
    """RGB of matplotlib.colormaps["turbo"](x)[..., :3] for x in [0, 1]:
    entry floor(x * 256), x == 1 taking the last."""
    xa = np.array(x, copy=True)
    xa *= len(TURBO)
    xa[xa == len(TURBO)] = len(TURBO) - 1
    return TURBO.take(np.clip(xa.astype(int), 0, len(TURBO) - 1), axis=0)


def depth_video_frames(depths: List[np.ndarray]) -> List[np.ndarray]:
    """--render_path's depth frames from [H, W] depth maps: the log depth
    between the 3rd and 97th percentiles of frame 0's positive depths,
    turbo-coloured (RGB in [0, 1])."""
    pos = depths[0][depths[0] > 0]
    lims = np.percentile(pos if pos.size else np.ones(1), [3, 97])
    lo, hi = np.log(np.maximum(lims, 1e-6))

    def frame(d):
        x = np.log(np.maximum(d, 1e-6))
        return turbo(np.clip((x - min(lo, hi)) / max(abs(hi - lo), 1e-9), 0, 1))

    return [frame(d) for d in depths]


def frames_u8(frames: List[np.ndarray]) -> np.ndarray:
    """RGB frames in [0, 1] as uint8 [n, H, W, 3], truncated as the JAX
    package's create_video and save_img_u8 quantize."""
    h, w = np.shape(frames[0])[:2]
    u8 = np.empty((len(frames), h, w, 3), np.uint8)
    for i, f in enumerate(frames):
        u8[i] = np.clip(np.asarray(f) * 255, 0, 255).astype(np.uint8)
    return u8


def create_video(frames: List[np.ndarray], path: str, fps: int = 30):
    """Write RGB frames in [0, 1] as an MP4 video: frames_u8, then MPEG-4
    Part 2 (mp4v), every frame intra-coded at io/video.VOP_QUANT, through
    the port's own encoder (io/video.py) on every machine."""
    write_video(path, frames_u8(frames), fps)
