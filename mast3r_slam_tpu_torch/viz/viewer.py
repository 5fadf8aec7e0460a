"""OpenGL viewer (interactive glfw window or headless EGL), run as a thread.

Counterpart of ``mast3r_slam_tpu/viz/viewer.py`` with the same shaders,
thread, callbacks and keys (the reference's in3d viewer): keyframe map
rendering with two pipelines, confidence-thresholded point splats and
normal-oriented surfel disks built in a geometry shader, plus the
trajectory polyline, camera frustums, factor-graph edges, an orbit / zoom
camera, keyboard controls that message state back to the main loop (pause,
confidence threshold, follow-cam, point / surfel switch) and the control
overlay (``viz/ui.py``).

Keyframe uploads are incremental through the buffer's dirty flags
(``KeyframeBuffer.get_dirty_idx``): :meth:`Viewer._refresh_dirty` clones a
dirty keyframe's tensors on their device under the buffer's lock (queued
behind the card's work; a host copy there would wait for all of it), then,
after the lock, computes its surfel normals from the pointmap grid on that
device and copies the keyframe to the host. :meth:`Viewer._gather_map`
builds the world-frame points on the host for each frame.

The viewer is host OpenGL, not the card's compute path. It runs as a
thread of the CLI's process; without a display it renders into a
surfaceless-EGL framebuffer (``viz/glctx.py``), the same GL code, which
``tests/test_torch_viewer_gl.py`` drives. Where no GL stack imports,
:meth:`Viewer.run` prints ``[viewer] disabled (...)`` and returns, as the
JAX viewer does; the software renderer (``viz/render.py``) still works.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from mast3r_slam_tpu_torch.ops import lie
from mast3r_slam_tpu_torch.viz.glctx import create_context
from mast3r_slam_tpu_torch.viz.render import (EDGE_COLOR, FRUSTUM_COLOR,
                                              FRUSTUM_LINES, TRAJ_COLOR,
                                              frustum_corners)
from mast3r_slam_tpu_torch.viz.ui import build_default_overlay

_VS = """
#version 330
in vec3 in_pos;
in vec3 in_color;
uniform mat4 mvp;
uniform float point_size;
out vec3 v_color;
void main() {
    gl_Position = mvp * vec4(in_pos, 1.0);
    gl_PointSize = point_size;
    v_color = in_color;
}
"""

_FS = """
#version 330
in vec3 v_color;
out vec4 frag;
void main() { frag = vec4(v_color, 1.0); }
"""

# Surfel pipeline: points + per-point normals in, screen-facing disks out.
_SURFEL_VS = """
#version 330
in vec3 in_pos;
in vec3 in_normal;
in vec3 in_color;
out vec3 g_normal;
out vec3 g_color;
void main() {
    gl_Position = vec4(in_pos, 1.0);
    g_normal = in_normal;
    g_color = in_color;
}
"""

_SURFEL_GS = """
#version 330
layout(points) in;
layout(triangle_strip, max_vertices = 4) out;
uniform mat4 mvp;
uniform float radius;
in vec3 g_normal[];
in vec3 g_color[];
out vec3 f_color;
out vec2 f_uv;
out vec3 f_normal;
void main() {
    vec3 p = gl_in[0].gl_Position.xyz;
    vec3 n = normalize(g_normal[0]);
    // tangent frame of the surfel plane (guard the degenerate up case)
    vec3 up = abs(n.y) > 0.93 ? vec3(1.0, 0.0, 0.0) : vec3(0.0, -1.0, 0.0);
    vec3 t = normalize(cross(n, up));
    vec3 b = cross(n, t);
    vec2 corners[4] = vec2[4](vec2(-1.0, -1.0), vec2(1.0, -1.0),
                              vec2(-1.0, 1.0), vec2(1.0, 1.0));
    for (int i = 0; i < 4; ++i) {
        vec3 q = p + (corners[i].x * t + corners[i].y * b) * radius;
        gl_Position = mvp * vec4(q, 1.0);
        f_color = g_color[0];
        f_uv = corners[i];
        f_normal = n;
        EmitVertex();
    }
    EndPrimitive();
}
"""

_SURFEL_FS = """
#version 330
in vec3 f_color;
in vec2 f_uv;
in vec3 f_normal;
uniform vec3 light_dir;
out vec4 frag;
void main() {
    if (dot(f_uv, f_uv) > 1.0) discard;   // round disk
    float lambert = 0.35 + 0.65 * abs(dot(normalize(f_normal),
                                          normalize(light_dir)));
    frag = vec4(f_color * lambert, 1.0);
}
"""



def _perspective(fovy, aspect, near, far):
    f = 1.0 / np.tan(np.radians(fovy) / 2)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def _grid_normals(X, h, w):
    """Per-point normals from the pointmap grid ``X (h*w, 3)``:
    normalize(cross(down, right)), on ``X``'s device; the last column and
    row reuse their neighbour's normal."""
    P = X.reshape(h, w, 3)
    right = torch.roll(P, -1, dims=1) - P
    down = torch.roll(P, -1, dims=0) - P
    n = torch.linalg.cross(down, right)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    n[:, -1] = n[:, -2]
    n[-1, :] = n[-2, :]
    return n.reshape(-1, 3).float()


def _compile_program(GL, *stages):
    prog = GL.glCreateProgram()
    for kind, src in stages:
        sh = GL.glCreateShader(kind)
        GL.glShaderSource(sh, src)
        GL.glCompileShader(sh)
        if not GL.glGetShaderiv(sh, GL.GL_COMPILE_STATUS):
            raise RuntimeError(GL.glGetShaderInfoLog(sh).decode())
        GL.glAttachShader(prog, sh)
    GL.glLinkProgram(prog)
    if not GL.glGetProgramiv(prog, GL.GL_LINK_STATUS):
        raise RuntimeError(GL.glGetProgramInfoLog(prog).decode())
    return prog


class Viewer(threading.Thread):
    """``error`` holds the exception that disabled the viewer (None while
    it can draw); ``frames`` counts the frames it rendered."""

    def __init__(self, keyframes, states, cfg, width=1280, height=720,
                 headless=None):
        super().__init__(daemon=True, name="viewer")
        self.keyframes = keyframes
        self.states = states
        self.cfg = cfg
        self.width, self.height = width, height
        self.headless = headless
        self.conf_threshold = 0.0
        self.follow = False
        self.surfel_mode = bool(cfg.get("viz", {}).get("surfels", True)) \
            if isinstance(cfg, dict) else True
        self.surfel_radius = 0.01
        self.should_close = threading.Event()
        self.error = None
        self.frames = 0
        self.overlay = build_default_overlay(self)
        self.show_ui = bool(cfg.get("viz", {}).get("ui", True)) \
            if isinstance(cfg, dict) else True
        # orbit camera state
        self.yaw, self.pitch, self.dist = 0.0, -0.4, 4.0
        self.center = np.zeros(3, np.float32)
        self._drag = None
        self._kf_points: dict[int, tuple] = {}

    # -- GL plumbing ---------------------------------------------------------

    def init_gl(self):
        # context first: the EGL backend must pick PyOpenGL's platform
        # BEFORE the first ``import OpenGL`` in this process
        self.ctx = create_context(self.width, self.height,
                                  headless=self.headless)
        from OpenGL import GL
        self.ctx.set_callbacks(scroll=self._on_scroll, cursor=self._on_cursor,
                               button=self._on_button, key=self._on_key)
        self.prog = _compile_program(
            GL, (GL.GL_VERTEX_SHADER, _VS), (GL.GL_FRAGMENT_SHADER, _FS))
        self.prog_surfel = _compile_program(
            GL, (GL.GL_VERTEX_SHADER, _SURFEL_VS),
            (GL.GL_GEOMETRY_SHADER, _SURFEL_GS),
            (GL.GL_FRAGMENT_SHADER, _SURFEL_FS))
        self.vao = GL.glGenVertexArrays(1)
        GL.glBindVertexArray(self.vao)
        # one dynamic VBO per attribute slot (core-profile VAOs reject
        # client-side array pointers)
        self._vbos = GL.glGenBuffers(4)
        GL.glEnable(GL.GL_DEPTH_TEST)
        GL.glEnable(GL.GL_VERTEX_PROGRAM_POINT_SIZE)
        self.GL = GL

    # -- input callbacks -----------------------------------------------------

    def _on_scroll(self, win, dx, dy):
        self.dist *= 0.9 ** dy

    def _on_button(self, win, button, action, mods):
        if action == 0:
            self.overlay.handle_release()
            self._drag = None
            return
        x, y = self.ctx.glfw.get_cursor_pos(win)
        # the overlay consumes clicks inside the panel; everything else
        # starts a camera drag
        if self.show_ui and self.overlay.handle_press(x, y):
            return
        self._drag = (x, y)

    def _on_cursor(self, win, x, y):
        if self.show_ui and self.overlay.handle_drag(x, y):
            return
        if self._drag is not None:
            x0, y0 = self._drag
            self.yaw += (x - x0) * 0.005
            self.pitch = np.clip(self.pitch + (y - y0) * 0.005, -1.5, 1.5)
            self._drag = (x, y)

    def _on_key(self, win, key, sc, action, mods):
        if action != 1:
            return
        g = self.ctx.glfw
        if key == g.KEY_SPACE:
            with self.states.lock:
                self.states.paused = not self.states.paused
        elif key == g.KEY_F:
            self.follow = not self.follow
        elif key == g.KEY_M:
            self.surfel_mode = not self.surfel_mode
        elif key == g.KEY_LEFT_BRACKET:
            self.surfel_radius = max(1e-4, self.surfel_radius * 0.8)
        elif key == g.KEY_RIGHT_BRACKET:
            self.surfel_radius *= 1.25
        elif key in (g.KEY_UP, g.KEY_EQUAL):
            self.conf_threshold += 0.25
        elif key in (g.KEY_DOWN, g.KEY_MINUS):
            self.conf_threshold = max(0.0, self.conf_threshold - 0.25)
        elif key in (g.KEY_ESCAPE, g.KEY_Q):
            self.should_close.set()

    # -- data upload ---------------------------------------------------------

    def _refresh_dirty(self):
        """Host copies of the dirty keyframes: (X, C / N, colours, T_WC,
        normals), each a CPU tensor."""
        kf = self.keyframes
        dirty = kf.get_dirty_idx()
        with kf.lock:
            n = len(kf)
            snap = [(int(i), kf.X[i].clone(), kf.C[i, :, 0].clone(),
                     max(int(kf.N[i]), 1), kf.T_WC[i].clone(), kf.uimg[i])
                    for i in dirty if i < n]
        for i, X, C, N, T, uimg in snap:
            nrm = _grid_normals(X, kf.h, kf.w)
            col = (torch.from_numpy(np.asarray(uimg, np.float32)
                                    .reshape(-1, 3))
                   if uimg is not None
                   else torch.full((X.shape[0], 3), 0.7))
            # C / N on the host: the card divides by a scalar through its
            # reciprocal, one rounding away from the division
            self._kf_points[i] = (X.cpu(), C.cpu() / N, col, T.cpu(),
                                  nrm.cpu())

    def _camera_mvp(self):
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        eye = self.center + self.dist * np.array(
            [sy * cp, sp, -cy * cp], np.float32
        )
        f = self.center - eye
        f /= np.linalg.norm(f) + 1e-9
        up = np.array([0, -1, 0], np.float32)
        s = np.cross(f, up)
        s /= np.linalg.norm(s) + 1e-9
        u = np.cross(s, f)
        # standard lookAt: camera forward maps to -z (GL clip space needs
        # w_clip = -z_view > 0 for visible geometry)
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = np.stack([s, u, -f])
        view[:3, 3] = -view[:3, :3] @ eye
        proj = _perspective(60, self.width / self.height, 0.01, 1000.0)
        return proj @ view

    def _gather_map(self):
        """Concatenate the confidence-passing world-frame points of all
        keyframes → numpy (points, colours, normals), or None."""
        pts, cols, nrms = [], [], []
        for i, (X, Cavg, col, T, nrm) in self._kf_points.items():
            keep = Cavg > self.conf_threshold
            Xw = lie.act(T[None], X)[keep]
            ok = torch.isfinite(Xw).all(1) & (Xw.abs() < 1e4).all(1)
            pts.append(Xw[ok])
            cols.append(col[keep][ok])
            R = lie.quat_to_matrix(lie.quaternion(T))
            nrms.append(nrm[keep][ok] @ R.T)
        if not pts:
            return None
        return tuple(torch.cat(a).numpy() for a in (pts, cols, nrms))

    _bind_slot = 0

    def _bind_attr(self, prog, name, arr, comps=3):
        GL = self.GL
        arr = np.ascontiguousarray(arr, np.float32)
        vbo = self._vbos[self._bind_slot % len(self._vbos)]
        self._bind_slot += 1
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo)
        GL.glBufferData(GL.GL_ARRAY_BUFFER, arr.nbytes, arr,
                        GL.GL_DYNAMIC_DRAW)
        loc = GL.glGetAttribLocation(prog, name)
        GL.glEnableVertexAttribArray(loc)
        GL.glVertexAttribPointer(loc, comps, GL.GL_FLOAT, False, 0,
                                 ctypes.c_void_p(0))
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, 0)
        return loc

    def _draw_points(self, mvp, P, C):
        GL = self.GL
        GL.glUseProgram(self.prog)
        GL.glUniformMatrix4fv(GL.glGetUniformLocation(self.prog, "mvp"), 1,
                              True, mvp.astype(np.float32))
        GL.glUniform1f(GL.glGetUniformLocation(self.prog, "point_size"), 2.0)
        locs = [self._bind_attr(self.prog, "in_pos", P),
                self._bind_attr(self.prog, "in_color", C)]
        GL.glDrawArrays(GL.GL_POINTS, 0, len(P))
        for loc in locs:
            GL.glDisableVertexAttribArray(loc)

    def _draw_surfels(self, mvp, P, C, N):
        GL = self.GL
        GL.glUseProgram(self.prog_surfel)
        GL.glUniformMatrix4fv(
            GL.glGetUniformLocation(self.prog_surfel, "mvp"), 1, True,
            mvp.astype(np.float32))
        GL.glUniform1f(GL.glGetUniformLocation(self.prog_surfel, "radius"),
                       self.surfel_radius)
        GL.glUniform3f(GL.glGetUniformLocation(self.prog_surfel, "light_dir"),
                       0.3, 0.5, 1.0)
        locs = [self._bind_attr(self.prog_surfel, "in_pos", P),
                self._bind_attr(self.prog_surfel, "in_color", C),
                self._bind_attr(self.prog_surfel, "in_normal", N)]
        GL.glDrawArrays(GL.GL_POINTS, 0, len(P))
        for loc in locs:
            GL.glDisableVertexAttribArray(loc)

    def _draw_lines(self, mvp, segments, color):
        if len(segments) == 0:
            return
        GL = self.GL
        P = np.asarray(segments, np.float32).reshape(-1, 3)
        C = np.tile(np.asarray(color, np.float32), (len(P), 1))
        GL.glUseProgram(self.prog)
        GL.glUniformMatrix4fv(GL.glGetUniformLocation(self.prog, "mvp"), 1,
                              True, mvp.astype(np.float32))
        locs = [self._bind_attr(self.prog, "in_pos", P),
                self._bind_attr(self.prog, "in_color", C)]
        GL.glDrawArrays(GL.GL_LINES, 0, len(P))
        for loc in locs:
            GL.glDisableVertexAttribArray(loc)

    # -- frame ---------------------------------------------------------------

    def render_frame(self):
        """One full render pass (also the unit-testable entry point)."""
        GL = self.GL
        self._refresh_dirty()
        with self.keyframes.lock:
            n = len(self.keyframes)
            traj = self.keyframes.T_WC[:n].clone() if n else None
        with self.states.lock:
            edges = list(zip(self.states.edges_ii, self.states.edges_jj))
        if traj is not None:
            traj = traj.cpu().numpy()
        if traj is not None and len(traj) and self.follow:
            self.center = traj[-1, :3]
        GL.glViewport(0, 0, self.width, self.height)
        GL.glClearColor(0.05, 0.05, 0.08, 1.0)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
        mvp = self._camera_mvp()
        m = self._gather_map()
        if m is not None:
            P, C, N = m
            if self.surfel_mode:
                self._draw_surfels(mvp, P, C, N)
            else:
                self._draw_points(mvp, P, C)
        if traj is not None and len(traj) > 1:
            segs = np.stack([traj[:-1, :3], traj[1:, :3]], 1)
            self._draw_lines(mvp, segs, TRAJ_COLOR)
            c = frustum_corners(torch.from_numpy(traj)).numpy()
            a, b = zip(*FRUSTUM_LINES)
            self._draw_lines(mvp, np.stack([c[:, list(a)], c[:, list(b)]], 2),
                             FRUSTUM_COLOR)
            eg = [(i, j) for i, j in edges if i < n and j < n]
            self._draw_lines(mvp, traj[np.asarray(eg, np.int64).reshape(-1),
                                       :3], EDGE_COLOR)
        if self.show_ui:
            self._draw_overlay()
        self.ctx.swap()

    def _draw_overlay(self):
        """Screen-space control panel (positions already in NDC)."""
        GL = self.GL
        P, C = self.overlay.triangles(self.width, self.height)
        GL.glDisable(GL.GL_DEPTH_TEST)
        GL.glUseProgram(self.prog)
        GL.glUniformMatrix4fv(GL.glGetUniformLocation(self.prog, "mvp"), 1,
                              True, np.eye(4, dtype=np.float32))
        locs = [self._bind_attr(self.prog, "in_pos", P),
                self._bind_attr(self.prog, "in_color", C)]
        GL.glDrawArrays(GL.GL_TRIANGLES, 0, len(P))
        for loc in locs:
            GL.glDisableVertexAttribArray(loc)
        GL.glEnable(GL.GL_DEPTH_TEST)

    # -- main loop -----------------------------------------------------------

    def run(self):
        try:
            self.init_gl()
        except Exception as e:
            self.error = e
            print(f"[viewer] disabled ({e}); use viz/render.py snapshots")
            return
        try:
            while not (self.ctx.should_close() or self.should_close.is_set()):
                self.render_frame()
                self.frames += 1
                time.sleep(1 / 30)
        except Exception as e:
            self.error = e
            raise
        finally:
            self.ctx.destroy()
