"""Sensor (camera) sampling: perspective, thinlens, orthographic,
telecentric, spherical, radiancemeter, fluencemeter, perspective_rdist.

Replacement for the sensor plugin family
(src/sensors/{perspective,thinlens,orthographic,telecentric,spherical,
radiancemeter,fluencemeter,perspective_rdist}.cpp).  Positions are in CONTINUOUS film
coordinates (pixels); matrices follow Mitsuba's cameraToSample
convention (built in scene/scene.py _build_sensor).  One branch-free
kernel covers all projection kinds (camera.kind selects lanes).

Normalization deviation: radiancemeter/fluencemeter films record the
MEAN sampled radiance (fluence / 4pi for the fluencemeter) rather than
the reference's integrated W/m^2 — the spp-normalized film is the
natural estimator in this wavefront design and differs only by the
constant 4pi (documented here and in tests/test_sensors.py).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import math as m
from ..core import warp


def sample_ray(camera, width, height, pos_film, u_aperture):
    """Generate camera rays.

    pos_film: [N, 2] continuous film position in pixels.
    u_aperture: [N, 2] lens samples (ignored when aperture_radius == 0).
    Returns (o_world [N,3], d_world [N,3]).
    """
    s = jnp.stack([pos_film[..., 0] / width, pos_film[..., 1] / height],
                  axis=-1)
    near = m.transform_point(
        camera.sample_to_camera,
        jnp.concatenate([s, jnp.zeros(s.shape[:-1] + (1,))], axis=-1))
    d_cam = m.normalize(near)
    o_cam = jnp.zeros_like(d_cam)

    # perspective_rdist (src/sensors/perspective_rdist.cpp): the film
    # records the DISTORTED projection xd = xu (1 + k1 r^2 + k2 r^4), so
    # ray generation inverts the radial polynomial — fixed-count Newton
    # on the scalar rd = ru f(ru) (branch-free; zeros kc = identity)
    k1, k2 = camera.kc[0], camera.kc[1]
    has_rd = (k1 != 0.0) | (k2 != 0.0)
    z_im = near[..., 2:3]
    xy_d = near[..., 0:2] / jnp.where(jnp.abs(z_im) > 1e-9, z_im, 1.0)
    rd = jnp.sqrt(jnp.sum(xy_d * xy_d, -1, keepdims=True))
    ru = rd
    for _ in range(4):
        r2 = ru * ru
        g = ru * (1.0 + r2 * (k1 + k2 * r2)) - rd
        dg = 1.0 + r2 * (3.0 * k1 + 5.0 * k2 * r2)
        ru = ru - g / jnp.where(jnp.abs(dg) > 1e-6, dg, 1.0)
    undist = jnp.where(rd > 1e-9, ru / jnp.maximum(rd, 1e-9), 1.0)
    d_rd = m.normalize(jnp.concatenate(
        [xy_d * undist, jnp.ones_like(z_im)], axis=-1))
    d_cam = jnp.where(has_rd & (camera.kind == 0.0), d_rd, d_cam)

    # thinlens: offset origin on the aperture disk, refocus through the
    # focal plane (thinlens.cpp sampleRay)
    aperture = camera.aperture_radius
    lens = warp.square_to_uniform_disk_concentric(u_aperture) * aperture
    o_lens = jnp.stack(
        [lens[..., 0], lens[..., 1], jnp.zeros_like(lens[..., 0])], axis=-1)
    t_focus = camera.focus_distance / jnp.maximum(d_cam[..., 2:3], 1e-9)
    p_focus = d_cam * t_focus
    d_lens = m.normalize(p_focus - o_lens)
    use_lens = aperture > 0.0
    o_cam = jnp.where(use_lens, o_lens, o_cam)
    d_cam = jnp.where(use_lens, d_lens, d_cam)

    # orthographic / telecentric (src/sensors/{orthographic,
    # telecentric}.cpp): origin on the film plane, direction along +z;
    # world extent comes from toWorld scale.  Telecentric = orthographic
    # with a per-pixel lens: offset the origin on the aperture disk and
    # refocus through the pixel's focal point.
    is_ortho = camera.kind == 1.0
    o_ortho = jnp.concatenate(
        [near[..., 0:2], jnp.zeros_like(near[..., 2:3])], axis=-1)
    d_ortho = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), d_cam.shape)
    p_focus_o = o_ortho + jnp.asarray([0.0, 0.0, 1.0]) * camera.focus_distance
    o_tele = o_ortho + o_lens
    d_tele = m.normalize(p_focus_o - o_tele)
    o_ortho = jnp.where(use_lens, o_tele, o_ortho)
    d_ortho = jnp.where(use_lens, d_tele, d_ortho)
    o_cam = jnp.where(is_ortho, o_ortho, o_cam)
    d_cam = jnp.where(is_ortho, d_ortho, d_cam)

    # spherical (src/sensors/spherical.cpp): lat-long mapping of the film,
    # d = (sin(phi) sin(theta), cos(theta), -cos(phi) sin(theta)) with
    # phi = (1 - x/W) 2pi, theta = (y/H) pi
    phi = (1.0 - pos_film[..., 0] / width) * (2.0 * jnp.pi)
    theta = (pos_film[..., 1] / height) * jnp.pi
    st_, ct_ = jnp.sin(theta), jnp.cos(theta)
    d_sph = jnp.stack([jnp.sin(phi) * st_, ct_, -jnp.cos(phi) * st_], -1)
    is_sph = camera.kind == 2.0
    o_cam = jnp.where(is_sph, jnp.zeros_like(o_cam), o_cam)
    d_cam = jnp.where(is_sph, d_sph, d_cam)

    # radiancemeter: every film sample measures the same (origin, +z) ray;
    # fluencemeter: uniform-sphere directions from the origin
    is_rad = camera.kind == 3.0
    o_cam = jnp.where(is_rad, jnp.zeros_like(o_cam), o_cam)
    d_cam = jnp.where(is_rad,
                      jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]),
                                       d_cam.shape), d_cam)
    is_flu = camera.kind == 4.0
    d_flu = warp.square_to_uniform_sphere(u_aperture)
    o_cam = jnp.where(is_flu, jnp.zeros_like(o_cam), o_cam)
    d_cam = jnp.where(is_flu, d_flu, d_cam)

    o_w = m.transform_point(camera.to_world, o_cam)
    d_w = m.normalize(m.transform_vector(camera.to_world, d_cam))
    return o_w, d_w


def importance_sample_direct(camera, width, height, p_world):
    """Project a world point to the film and compute sensor importance —
    needed by BDPT's t=1 (light tracing) connections
    (perspective.cpp sampleDirect/evalDirection semantics).

    Returns (film_pos [N,2] pixels, importance_weight [N] = W_e/pdf terms
    folded: We * G-to-directional conversion, valid [N]).
    """
    p_cam = m.transform_point(camera.world_to_camera, p_world)
    z = p_cam[..., 2]
    s = m.transform_point(camera.camera_to_sample, p_cam)
    # perspective_rdist: forward-distort the image-plane point before the
    # sample-space transform (light-tracing splats land on the distorted
    # film; importance itself is the undistorted cos^4 model — deviation)
    k1, k2 = camera.kc[0], camera.kc[1]
    has_rd = (k1 != 0.0) | (k2 != 0.0)
    zc = jnp.where(jnp.abs(z) > 1e-9, z, 1.0)[..., None]
    xy_u = p_cam[..., 0:2] / zc
    r2 = jnp.sum(xy_u * xy_u, -1, keepdims=True)
    f_rd = 1.0 + r2 * (k1 + k2 * r2)
    p_dist = jnp.concatenate([xy_u * f_rd * zc, p_cam[..., 2:3]], axis=-1)
    s_rd = m.transform_point(camera.camera_to_sample, p_dist)
    s = jnp.where(has_rd & (camera.kind == 0.0), s_rd, s)
    in_frustum = ((z > 1e-6) & (s[..., 0] >= 0) & (s[..., 0] < 1) &
                  (s[..., 1] >= 0) & (s[..., 1] < 1))
    film = jnp.stack([s[..., 0] * width, s[..., 1] * height], axis=-1)

    # importance: We(p) = 1 / (A_image * cos^4 theta) in directional measure;
    # the connection kernel multiplies by the geometry term itself.
    d_cam = m.normalize(p_cam)
    cos_theta = d_cam[..., 2]
    # image-plane area at z=1 in camera space:
    x0 = m.transform_point(camera.sample_to_camera,
                           jnp.array([0.0, 0.0, 0.0]))
    x1 = m.transform_point(camera.sample_to_camera,
                           jnp.array([1.0, 1.0, 0.0]))
    x0 = x0 / x0[..., 2:3]
    x1 = x1 / x1[..., 2:3]
    image_area = jnp.abs((x1[..., 0] - x0[..., 0]) *
                         (x1[..., 1] - x0[..., 1]))
    we = 1.0 / jnp.maximum(image_area * cos_theta ** 4, 1e-12)
    # orthographic: parallel projection, constant importance per area
    x0o = m.transform_point(camera.sample_to_camera,
                            jnp.array([0.0, 0.0, 0.0]))
    x1o = m.transform_point(camera.sample_to_camera,
                            jnp.array([1.0, 1.0, 0.0]))
    area_o = jnp.abs((x1o[..., 0] - x0o[..., 0]) *
                     (x1o[..., 1] - x0o[..., 1]))
    we = jnp.where(camera.kind == 1.0,
                   1.0 / jnp.maximum(area_o, 1e-12), we)

    # spherical: invert the lat-long mapping; We = 1/(2 pi^2 sin(theta))
    # per unit solid angle (integrates to 1 over the sphere)
    d_sph = m.normalize(p_cam)
    theta_s = jnp.arccos(jnp.clip(d_sph[..., 1], -1.0, 1.0))
    phi_s = jnp.arctan2(d_sph[..., 0], -d_sph[..., 2]) % (2.0 * jnp.pi)
    fx = (1.0 - phi_s / (2.0 * jnp.pi)) % 1.0
    fy = theta_s / jnp.pi
    film_sph = jnp.stack([fx * width, fy * height], axis=-1)
    sin_t = jnp.maximum(jnp.sin(theta_s), 1e-6)
    we_sph = 1.0 / (2.0 * jnp.pi ** 2 * sin_t)
    is_sph = camera.kind == 2.0
    film = jnp.where(is_sph, film_sph, film)
    we = jnp.where(is_sph, we_sph, we)
    in_frustum = in_frustum | (is_sph & (m.squared_length(p_cam) > 1e-12))
    # radiancemeter/fluencemeter: no meaningful light-tracing connection
    # to an image plane — mark invalid (matches their delta importance)
    meter = camera.kind >= 3.0
    in_frustum = in_frustum & ~meter
    return film, jnp.where(in_frustum, we, 0.0), in_frustum
