"""OpenGL context backends: interactive glfw window or headless EGL.

The reference viewer can only run with a display (in3d/glfw — reference
visualization.py:383-445); here context creation is factored behind one
interface so the SAME render pipeline drives both the interactive window and
a display-less surfaceless-EGL context (Mesa llvmpipe in CI/containers),
which is what lets the GL code path be exercised by tests
(tests/test_torch_viewer_gl.py) instead of shipping forever-unexecuted.
"""

from __future__ import annotations

import ctypes

import numpy as np


class GlfwContext:
    """Interactive double-buffered window with input callbacks."""

    interactive = True

    def __init__(self, width, height, title="MASt3R-SLAM-TPU"):
        import glfw

        if not glfw.init():
            raise RuntimeError("glfw init failed (no display?)")
        glfw.window_hint(glfw.VISIBLE, True)
        self.win = glfw.create_window(width, height, title, None, None)
        if not self.win:
            glfw.terminate()
            raise RuntimeError("glfw window creation failed")
        glfw.make_context_current(self.win)
        self.glfw = glfw
        self.width, self.height = width, height

    def set_callbacks(self, scroll=None, cursor=None, button=None, key=None):
        g = self.glfw
        if scroll:
            g.set_scroll_callback(self.win, scroll)
        if cursor:
            g.set_cursor_pos_callback(self.win, cursor)
        if button:
            g.set_mouse_button_callback(self.win, button)
        if key:
            g.set_key_callback(self.win, key)

    def should_close(self):
        return self.glfw.window_should_close(self.win)

    def swap(self):
        self.glfw.swap_buffers(self.win)
        self.glfw.poll_events()

    def read_pixels(self):
        from OpenGL import GL

        buf = GL.glReadPixels(0, 0, self.width, self.height, GL.GL_RGB,
                              GL.GL_UNSIGNED_BYTE)
        img = np.frombuffer(buf, np.uint8).reshape(self.height, self.width, 3)
        return img[::-1]

    def destroy(self):
        self.glfw.terminate()


class EglContext:
    """Headless surfaceless-EGL context rendering into an FBO."""

    interactive = False

    def __init__(self, width, height, **_):
        import os
        import sys

        os.environ.setdefault("EGL_PLATFORM", "surfaceless")
        # PyOpenGL picks its platform (GLX vs EGL) at first import; without
        # this, array-pointer calls fail with "no valid context" because the
        # GLX platform can't see the EGL context.
        if "OpenGL" not in sys.modules:
            os.environ["PYOPENGL_PLATFORM"] = "egl"
        from OpenGL import EGL, GL
        from OpenGL.EGL import EGLConfig

        self.width, self.height = width, height
        dpy = EGL.eglGetDisplay(EGL.EGL_DEFAULT_DISPLAY)
        major, minor = ctypes.c_long(), ctypes.c_long()
        if not EGL.eglInitialize(dpy, major, minor):
            raise RuntimeError("eglInitialize failed")
        attribs = [
            EGL.EGL_SURFACE_TYPE, EGL.EGL_PBUFFER_BIT,
            EGL.EGL_RED_SIZE, 8, EGL.EGL_GREEN_SIZE, 8,
            EGL.EGL_BLUE_SIZE, 8, EGL.EGL_DEPTH_SIZE, 24,
            EGL.EGL_RENDERABLE_TYPE, EGL.EGL_OPENGL_BIT, EGL.EGL_NONE,
        ]
        configs = (EGLConfig * 4)()
        num = ctypes.c_long()
        if not EGL.eglChooseConfig(
            dpy, (ctypes.c_int * len(attribs))(*attribs), configs, 4, num
        ) or num.value < 1:
            raise RuntimeError("eglChooseConfig found no config")
        EGL.eglBindAPI(EGL.EGL_OPENGL_API)
        ctx = EGL.eglCreateContext(dpy, configs[0], EGL.EGL_NO_CONTEXT, None)
        if not ctx:
            raise RuntimeError("eglCreateContext failed")
        if not EGL.eglMakeCurrent(dpy, EGL.EGL_NO_SURFACE, EGL.EGL_NO_SURFACE,
                                  ctx):
            raise RuntimeError("eglMakeCurrent failed")
        self._egl = (EGL, dpy, ctx)

        # color + depth renderbuffer FBO as the default render target
        self.fbo = GL.glGenFramebuffers(1)
        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self.fbo)
        color = GL.glGenRenderbuffers(1)
        GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, color)
        GL.glRenderbufferStorage(GL.GL_RENDERBUFFER, GL.GL_RGB8, width, height)
        GL.glFramebufferRenderbuffer(GL.GL_FRAMEBUFFER, GL.GL_COLOR_ATTACHMENT0,
                                     GL.GL_RENDERBUFFER, color)
        depth = GL.glGenRenderbuffers(1)
        GL.glBindRenderbuffer(GL.GL_RENDERBUFFER, depth)
        GL.glRenderbufferStorage(GL.GL_RENDERBUFFER, GL.GL_DEPTH_COMPONENT24,
                                 width, height)
        GL.glFramebufferRenderbuffer(GL.GL_FRAMEBUFFER, GL.GL_DEPTH_ATTACHMENT,
                                     GL.GL_RENDERBUFFER, depth)
        assert (GL.glCheckFramebufferStatus(GL.GL_FRAMEBUFFER)
                == GL.GL_FRAMEBUFFER_COMPLETE)

    def set_callbacks(self, **_):
        pass

    def should_close(self):
        return False

    def swap(self):
        from OpenGL import GL

        GL.glFlush()

    def read_pixels(self):
        from OpenGL import GL

        GL.glBindFramebuffer(GL.GL_FRAMEBUFFER, self.fbo)
        buf = GL.glReadPixels(0, 0, self.width, self.height, GL.GL_RGB,
                              GL.GL_UNSIGNED_BYTE)
        img = np.frombuffer(buf, np.uint8).reshape(self.height, self.width, 3)
        return img[::-1]

    def destroy(self):
        EGL, dpy, ctx = self._egl
        EGL.eglMakeCurrent(dpy, EGL.EGL_NO_SURFACE, EGL.EGL_NO_SURFACE,
                           EGL.EGL_NO_CONTEXT)
        EGL.eglDestroyContext(dpy, ctx)
        EGL.eglTerminate(dpy)


def create_context(width, height, headless=None):
    """glfw window if a display is available (and ``headless`` is not
    forced), else surfaceless EGL. Raises RuntimeError if neither works."""
    if headless is not True:
        try:
            return GlfwContext(width, height)
        except Exception:
            if headless is False:
                raise
    return EglContext(width, height)
