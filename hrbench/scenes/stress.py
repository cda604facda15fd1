"""The stress scene: the port's ``make_stress_scene``, a grid of instanced
procedural meshes with a sun and point lights, static.

A configuration's ``scene``: ``{"kind": "stress", "grid", "seed",
"lod_rich"}`` (``lod_rich`` defaults to true). The CPU rehearsal's
overrides ``grid`` and ``lod_rich`` take the configuration's place."""


def make(params: dict, overrides: dict, tmpdir: str):
    """(scene, the Config keywords this kind sets) for ``params``."""
    from hobbyrenderer_tpu_torch.scene.procedural import make_stress_scene
    sc = dict(params, **{k: v for k, v in overrides.items() if k in ("grid", "lod_rich")})
    scene = make_stress_scene(grid=int(sc["grid"]), seed=int(sc["seed"]),
                              lod_rich=bool(sc.get("lod_rich", True)))
    return scene, {"scene": "stress"}
