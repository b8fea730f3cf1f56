"""Offline mesh renderer (the port of ``msmd_tpu/utils/renderer.py``;
reference: utils/renderer.py:14-136): a pyrender / EGL offscreen renderer
with a 5-light rig, off the main path (no main-path module imports it, in
the reference either).

pyrender and trimesh are imported when a renderer is made, so a machine
without a GL stack can import the package. The rotation is a plain
axis-angle Rodrigues in NumPy (no cv2), and meshes are trimesh meshes
(no psbody.mesh)."""

from __future__ import annotations

import numpy as np


def _rodrigues(rot: np.ndarray) -> np.ndarray:
    """axis-angle (3,) -> rotation matrix (3, 3), without cv2."""
    theta = float(np.linalg.norm(rot))
    if theta < 1e-12:
        return np.eye(3)
    k = rot / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class MeshRenderer:
    """Offscreen renderer: ``render_mesh(vertices, faces, t_center)``
    -> (color, depth)."""

    def __init__(self, size, fov=16 / 180 * np.pi, camera_pose=None, light_pose=None, black_bg=False):
        import os

        os.environ.setdefault("PYOPENGL_PLATFORM", "egl")
        import pyrender

        self._pyrender = pyrender
        self.frustum = {"near": 0.01, "far": 3.0}
        self.camera = pyrender.PerspectiveCamera(
            yfov=fov, znear=self.frustum["near"], zfar=self.frustum["far"], aspectRatio=1.0
        )
        self.primitive_material = pyrender.material.MetallicRoughnessMaterial(
            alphaMode="BLEND", baseColorFactor=[0.3, 0.3, 0.3, 1.0], metallicFactor=0.8, roughnessFactor=0.8
        )
        self.light = pyrender.DirectionalLight(color=np.array([1.0, 1.0, 1.0]), intensity=2)
        self.light_angle = np.pi / 6.0

        bg = [0, 0, 0] if black_bg else [255, 255, 255]
        self.scene = pyrender.Scene(ambient_light=[0.2, 0.2, 0.2], bg_color=bg)

        if camera_pose is None:
            camera_pose = np.eye(4)
            camera_pose[:3, 3] = np.array([0, 0, 1])
        self.camera_pose = camera_pose.copy()
        self.camera_node = self.scene.add(self.camera, pose=camera_pose)

        if light_pose is None:
            light_pose = np.eye(4)
            light_pose[:3, 3] = np.array([0, 0, 1])
        self.light_pose = light_pose.copy()
        self.light_nodes = [
            self.scene.add(self.light, pose=pose) for pose in self._get_light_poses(self.light_angle, light_pose)
        ]

        self.renderer = pyrender.OffscreenRenderer(*size, point_size=1.0)

    def set_camera_pose(self, camera_pose):
        self.camera_pose = camera_pose.copy()
        self.scene.set_pose(self.camera_node, pose=camera_pose)

    def set_lighting_pose(self, light_pose):
        self.light_pose = light_pose.copy()
        for node, pose in zip(self.light_nodes, self._get_light_poses(self.light_angle, light_pose)):
            self.scene.set_pose(node, pose=pose)

    def render_mesh(self, vertices, faces, t_center, rot=np.zeros(3), tex_img=None, tex_uv=None, camera_pose=None, light_pose=None):
        """Render one mesh. ``vertices`` (V, 3), ``faces`` (F, 3);
        rotated about ``t_center`` by axis-angle ``rot``."""
        import trimesh

        pyrender = self._pyrender
        v = _rodrigues(np.asarray(rot)).dot((np.asarray(vertices) - t_center).T).T + t_center

        if tex_img is not None:
            tex = pyrender.Texture(source=tex_img, source_channels="RGB")
            material = pyrender.material.MetallicRoughnessMaterial(baseColorTexture=tex)
            visual = trimesh.visual.TextureVisuals(uv=tex_uv["vt"]) if tex_uv is not None else None
            tri = trimesh.Trimesh(vertices=v, faces=faces, visual=visual, process=False)
            render_mesh = pyrender.Mesh.from_trimesh(tri, material=material)
        else:
            tri = trimesh.Trimesh(vertices=v, faces=faces)
            render_mesh = pyrender.Mesh.from_trimesh(tri, material=self.primitive_material, smooth=True)
        node = self.scene.add(render_mesh, pose=np.eye(4))

        if camera_pose is not None:
            self.set_camera_pose(camera_pose)
        if light_pose is not None:
            self.set_lighting_pose(light_pose)

        color, depth = self.renderer.render(self.scene, flags=pyrender.RenderFlags.SKIP_CULL_FACES)
        self.scene.remove_node(node)
        return color, depth

    @staticmethod
    def _get_light_poses(light_angle, light_pose):
        """The reference's 5-light rig: center + up/down/left/right
        rotations of the light position (reference: utils/renderer.py:109-129)."""
        poses = []
        init_pos = light_pose[:3, 3].copy()
        poses.append(light_pose.copy())
        for axis_rot in ([light_angle, 0, 0], [-light_angle, 0, 0], [0, -light_angle, 0], [0, light_angle, 0]):
            p = light_pose.copy()
            p[:3, 3] = _rodrigues(np.array(axis_rot, float)).dot(init_pos)
            poses.append(p)
        return poses
