"""The animated, environment-lit stress scene that chip_smoke.py and
profile_frame.py render (the per-frame refit's and the env lights'
workload): node animations added to a finalized scene, and an equirect HDR
sky made from a seed."""

from __future__ import annotations

import numpy as np

from hobbyrenderer_tpu_torch.ops.envmap import _equirect_dirs_dw
from hobbyrenderer_tpu_torch.scene.scene import Animation, AnimationChannel


def sky_envmap(height: int, width: int, seed: int = 0) -> np.ndarray:
    """(height, width, 3) f32 linear equirect sky: a gradient from a bright
    horizon to a deep-blue zenith over a dim ground, a bright lobe (a disk
    of radiance ~2,000 and a halo) at a random direction of the upper
    hemisphere, and 5% per-texel noise."""
    rng = np.random.default_rng(seed)
    d, _ = _equirect_dirs_dw(height, width)
    y = d[:, 1:2]
    up = np.clip(y, 0.0, 1.0)
    sky = (np.asarray([1.0, 0.9, 0.8]) * (1 - up) + np.asarray([0.15, 0.3, 0.9]) * up)
    sky = np.where(y < 0, np.asarray([0.25, 0.22, 0.2]) * (1 + 0.5 * y), sky)
    az, el = rng.uniform(0, 2 * np.pi), rng.uniform(0.3, 1.2)
    lobe_dir = np.asarray([np.cos(el) * np.sin(az), np.sin(el), -np.cos(el) * np.cos(az)])
    c = d @ lobe_dir
    lobe = 2000.0 * np.exp((c - 1.0) / 2e-4) + 20.0 * np.exp((c - 1.0) / 0.02)
    img = sky + lobe[:, None] * np.asarray([1.0, 0.95, 0.85])
    img = img * (1.0 + 0.05 * rng.random(img.shape))
    return img.reshape(height, width, 3).astype(np.float32)


def _quat_mul(a, b):
    """Hamilton product of (x, y, z, w) quaternions."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], np.float32)


def animate_nodes(scene, every: int = 8, duration: float = 2.0, lift: float = 0.75):
    """Give every ``every``-th node, from node ``every`` on (node 0 is the
    stress scene's ground), a looping translation channel (up by ``lift``
    and back) and a rotation channel (one turn about +y on top of its own
    rotation), both ``duration`` seconds long. Returns the scene."""
    times = np.asarray([0.0, duration / 2, duration], np.float32)
    channels = []
    for ni in range(every, len(scene.nodes), every):
        node = scene.nodes[ni]
        t = np.asarray(node.translation, np.float32)
        channels.append(AnimationChannel(
            target_node=ni, path="translation", times=times,
            values=np.stack([t, t + np.asarray([0.0, lift, 0.0], np.float32), t])))
        turns = [np.array([0.0, np.sin(a / 2), 0.0, np.cos(a / 2)], np.float32)
                 for a in (0.0, np.pi, 2 * np.pi)]
        channels.append(AnimationChannel(
            target_node=ni, path="rotation", times=times,
            values=np.stack([_quat_mul(q, node.rotation) for q in turns])))
    scene.animations.append(Animation(name="orbit", channels=channels, duration=duration))
    return scene
