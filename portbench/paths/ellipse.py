"""The novel-view ellipse through the training cameras: the published
Mip-NeRF 360 ellipse path (Google's multinerf, Apache-2.0) as 2DGS's
render_utils.generate_path applies it, copied here so that the yardstick
does not move with the program."""
import numpy as np


def _normalize(x):
    return x / np.linalg.norm(x)


def _pad(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def _viewmatrix(lookdir, up, position):
    v2 = _normalize(lookdir)
    v0 = _normalize(np.cross(up, v2))
    v1 = _normalize(np.cross(v2, v0))
    return np.stack([v0, v1, v2, position], axis=1)


def _focus_point(poses):
    d, o = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - d * np.transpose(d, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ o).mean(0)[:, 0]


def _pca(poses):
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eig(t.T @ t)
    rot = eigvec[:, np.argsort(eigval)[::-1]].T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1, 1, -1]) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    recentered = (transform @ _pad(poses))[..., :3, :4]
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if recentered.mean(axis=0)[2, 1] < 0:
        recentered = np.diag([1, -1, -1]) @ recentered
        transform = np.diag([1, -1, -1, 1]) @ transform
    return np.real(recentered), np.real(transform)


def _ellipse(poses, n_frames):
    center = _focus_point(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = -sc + offset, sc + offset
    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
    pos = np.stack([low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
                    low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
                    np.zeros_like(theta)], -1)[:-1]
    avg_up = _normalize(poses[:, :3, 1].mean(0))
    i = np.argmax(np.abs(avg_up))
    up = np.eye(3)[i] * np.sign(avg_up[i])
    return np.stack([_viewmatrix(p - center, up, p) for p in pos])


def make(cams, n_frames: int):
    """(R, t) of each frame, in the cameras' convention."""
    c2w = []
    for c in cams:
        m = np.eye(4)
        m[:3, :3] = c["R"]
        m[:3, 3] = -np.asarray(c["R"]) @ np.asarray(c["t"])
        c2w.append(m)
    pose = np.stack(c2w)[:, :3, :] @ np.diag([1, -1, -1, 1])
    recentered, to_world = _pca(pose)
    new = np.linalg.inv(to_world) @ _pad(_ellipse(recentered, n_frames))
    out = []
    for m in new:
        w2c = np.linalg.inv(m @ np.diag([1, -1, -1, 1.0]))
        out.append((w2c[:3, :3].T, w2c[:3, 3]))
    return out
