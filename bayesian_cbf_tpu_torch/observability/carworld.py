"""CarWorld: the car experiments' 3D scene, drawn headless.

The reference's bayes_cbf/car/vis.py:10-66 (CarWorld / CarWithObstacles)
renders a textured car mesh, walls, obstacles and a goal through
vtkplotter, interactively.  Here the same surface (setCarPose / setGoal /
addObstacle / show / close) draws through matplotlib's 3D axes (imported
inside: ImportError without it): a box with a heading nose for the car,
cylinders for the obstacles, a marker for the goal; `show(savefile=...)`
writes a frame, and `render_car_trajectory` an animation.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


def _car_vertices(x, y, theta, length=0.5, width=0.25, height=0.15):
    """8 corners of the car box at pose (x, y, theta)."""
    c, s = math.cos(theta), math.sin(theta)
    R = np.array([[c, -s], [s, c]])
    corners2d = np.array([[dx, dy] for dx in (-length / 2, length / 2)
                          for dy in (-width / 2, width / 2)])
    xy = corners2d @ R.T + np.array([x, y])
    out = []
    for z in (0.0, height):
        for p in xy:
            out.append([p[0], p[1], z])
    return np.asarray(out)


class CarWithObstacles:
    """Headless 3D car + obstacles + goal scene (car/vis.py:35-66)."""

    def __init__(self, figsize=(5, 5)):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        self._plt = plt
        self.fig = plt.figure(figsize=figsize)
        self.ax = self.fig.add_subplot(projection="3d")
        self.car_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0)
        self.goal: Optional[Tuple[float, float]] = None
        self.obstacles: List[Tuple[float, float, float]] = []

    def setCarPose(self, x, y, theta):
        self.car_pose = (float(x), float(y), float(theta))

    def setGoal(self, x, y):
        self.goal = (float(x), float(y))

    def addObstacle(self, x, y, radius):
        self.obstacles.append((float(x), float(y), float(radius)))

    def _draw(self):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection
        ax = self.ax
        ax.clear()
        x, y, th = self.car_pose
        v = _car_vertices(x, y, th)
        faces = [[v[i] for i in face] for face in
                 ((0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
                  (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5))]
        ax.add_collection3d(Poly3DCollection(faces, facecolor="tab:blue",
                                             edgecolor="k", alpha=0.9))
        # heading nose
        ax.plot([x, x + 0.4 * math.cos(th)], [y, y + 0.4 * math.sin(th)],
                [0.08, 0.08], "b-", lw=2)
        # obstacle cylinders
        zs = np.linspace(0, 1.0, 8)
        phis = np.linspace(0, 2 * math.pi, 24)
        for ox, oy, r in self.obstacles:
            P, Z = np.meshgrid(phis, zs)
            ax.plot_surface(ox + r * np.cos(P), oy + r * np.sin(P), Z,
                            color="darkgreen", alpha=0.5, linewidth=0)
        if self.goal is not None:
            ax.scatter([self.goal[0]], [self.goal[1]], [0.2], s=120,
                       c="gold", alpha=0.8, marker="o")
        pts = [np.array([x, y])] + [np.array(o[:2]) for o in self.obstacles]
        if self.goal is not None:
            pts.append(np.array(self.goal))
        pts = np.stack(pts)
        lo = pts.min(0) - 1.5
        hi = pts.max(0) + 1.5
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(0, max(2.0, float(hi[0] - lo[0]) / 4))

    def show(self, savefile: Optional[str] = None):
        self._draw()
        if savefile is not None:
            self.fig.savefig(savefile, dpi=110)
            return savefile
        return self.fig

    def close(self):
        self._plt.close(self.fig)


class CarWorld(CarWithObstacles):
    """Walled car world (car/vis.py:10-32); walls enter as rectangular
    obstacle footprints approximated by cylinder rows."""

    def __init__(self, wall_box=((-1.0, -8.0), (19.0, 12.0)), **kw):
        super().__init__(**kw)
        (x0, y0), (x1, y1) = wall_box
        for t in np.linspace(0, 1, 12):
            self.addObstacle(x0 + t * (x1 - x0), y0, 0.3)
            self.addObstacle(x0 + t * (x1 - x0), y1, 0.3)
        for t in np.linspace(0, 1, 8)[1:-1]:
            self.addObstacle(x0, y0 + t * (y1 - y0), 0.3)
            self.addObstacle(x1, y0 + t * (y1 - y0), 0.3)


def render_car_trajectory(X, obstacles=(), goal=None, savefile=None,
                          stride=8, fps=12):
    """Animate a pose trajectory through the 3D car world to GIF/mp4 —
    the car-demo playback (reference car/main.py drives CarWorld per
    step)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import animation
    world = CarWithObstacles()
    for (ox, oy, r) in obstacles:
        world.addObstacle(ox, oy, r)
    if goal is not None:
        world.setGoal(goal[0], goal[1])
    if hasattr(X, "detach"):
        X = X.detach().cpu().numpy()
    X = np.asarray(X)

    def draw(i):
        world.setCarPose(*X[i, :3])
        world._draw()
        return []

    frames = range(0, X.shape[0], stride)
    ani = animation.FuncAnimation(world.fig, draw, frames=frames,
                                  blit=False)
    if savefile is None:
        savefile = "car_trajectory.gif"
    if savefile.endswith(".mp4") and animation.writers.is_available("ffmpeg"):
        ani.save(savefile, writer="ffmpeg", fps=fps)
    else:
        if savefile.endswith(".mp4"):
            savefile = savefile[:-4] + ".gif"
        ani.save(savefile, writer=animation.PillowWriter(fps=fps))
    world.close()
    return savefile
