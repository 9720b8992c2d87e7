"""The camera traffic's world, frozen (a copy of the port's
``data/tood_synth.py``: ``make_world`` and ``simulate_sequence``, with the
edge windows of ``perf/profile_step.py::edge_windows``).

The benchmark keeps its own copy so that no later change to the program
moves the yardstick: the same seed gives the same scenes, proposals and
features whatever the program's data module does. Pure numpy.

World model (unchanged from the copied module):
  * M object classes with prototype features in R^d (the CLIP-proxy space);
  * T tasks; a task's relevant classes come from a relation graph
    (task -used-for-> class);
  * scenes hold drifting objects (temporal coherence) plus background
    clutter; proposals = jittered GT boxes + false positives;
  * proposal features = class prototype + difficulty-scaled noise, drifting
    with scene motion so consecutive windows' queries are similar.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TASKS = ["pour wine", "sports", "cooking", "have breakfast", "take a rest"]

# scene dynamics per task
_TASK_DYNAMICS = {
    # size < 1 makes objects smaller (harder IoU matching) — the paper's
    # Table 5 shows breakfast/rest are intrinsically harder for *every*
    # method (iTaskCLIP drops from ~63 to ~44 AP there too).
    "pour wine": dict(motion=0.05, churn=0.10, n_objects=9, size=1.20),
    "sports": dict(motion=0.09, churn=0.16, n_objects=11, size=1.15),
    "cooking": dict(motion=0.04, churn=0.08, n_objects=8, size=0.95),
    "have breakfast": dict(motion=0.02, churn=0.04, n_objects=7, size=0.62),
    "take a rest": dict(motion=0.02, churn=0.05, n_objects=7, size=0.62),
}


@dataclasses.dataclass
class World:
    prototypes: np.ndarray      # [M, d] class features (unit norm)
    relevance: np.ndarray       # [T, M] in [0, 1]: task-class affinity
    task_paths: np.ndarray      # [T, max_hops] relation ids (-1 pad)
    n_relations: int


def make_world(seed: int, M: int = 64, d: int = 512, n_tasks: int = 5,
               n_relations: int = 16, max_hops: int = 3) -> World:
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((M, d))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    # relation graph: each relation maps tasks to a class subset
    rel_class = rng.random((n_relations, M)) < 0.15
    relevance = np.zeros((n_tasks, M))
    task_paths = np.full((n_tasks, max_hops), -1, np.int32)
    for t in range(n_tasks):
        hops = rng.integers(1, max_hops + 1)
        rels = rng.choice(n_relations, size=hops, replace=False)
        task_paths[t, :hops] = rels
        mask = np.ones(M, bool)
        for r in rels:
            mask &= rel_class[r]
        if mask.sum() < 3:  # ensure each task has targets
            mask |= rng.random(M) < 0.08
        relevance[t] = np.where(mask, 1.0, 0.1)
    return World(protos, relevance, task_paths, n_relations)


@dataclasses.dataclass
class Frame:
    feats: np.ndarray        # [N, d] proposal features
    boxes: np.ndarray        # [N, 4] xyxy in [0,1]
    classes: np.ndarray      # [N] true class (-1 for background clutter)
    valid: np.ndarray        # [N] bool
    gt_boxes: np.ndarray     # [G, 4] task-relevant GT boxes
    gt_classes: np.ndarray   # [G]


def _rand_boxes(rng, n, size=1.0):
    cx, cy = rng.random((2, n))
    w, h = (0.08 + 0.12 * rng.random((2, n))) * size
    return np.clip(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            axis=1), 0, 1)


def simulate_sequence(world: World, task_id: int, n_frames: int,
                      seed: int, difficulty: float = 0.55,
                      n_max: int = 16) -> list[Frame]:
    """Temporal sequence with drifting objects and churn."""
    task = TASKS[task_id]
    dyn = _TASK_DYNAMICS[task]
    rng = np.random.default_rng((seed, task_id))
    M, d = world.prototypes.shape
    n_obj = dyn["n_objects"]

    relevant_classes = np.flatnonzero(world.relevance[task_id] > 0.5)

    def draw_class():
        # evaluation scenes contain target objects ~40% of the time
        if len(relevant_classes) and rng.random() < 0.4:
            return int(rng.choice(relevant_classes))
        return int(rng.integers(0, M))

    classes = np.array([draw_class() for _ in range(n_obj)])
    boxes = _rand_boxes(rng, n_obj, dyn["size"])
    base_noise = rng.standard_normal((n_obj, d)) * difficulty

    frames = []
    for _ in range(n_frames):
        # churn: some objects leave/arrive
        for i in range(n_obj):
            if rng.random() < dyn["churn"]:
                classes[i] = draw_class()
                boxes[i] = _rand_boxes(rng, 1, dyn["size"])[0]
                base_noise[i] = rng.standard_normal(d) * difficulty
        # motion: boxes drift, features drift proportionally
        drift = rng.standard_normal((n_obj, 4)) * dyn["motion"] * 0.06
        boxes = np.clip(boxes + drift, 0, 1)
        base_noise += rng.standard_normal((n_obj, d)) * dyn["motion"] * difficulty
        base_noise *= difficulty / (np.linalg.norm(base_noise, axis=1, keepdims=True)
                                    / np.sqrt(d) + 1e-9) * 1.0

        feats_obj = world.prototypes[classes] + base_noise / np.sqrt(d)
        # proposals: true objects (jittered) + hard-negative clutter
        # (spurious detections that *look like* real classes — the FP mode a
        # real detector produces; random-feature clutter is trivially
        # rejected by any aligner and would inflate AP to ~100)
        n_clutter = rng.integers(2, 5)
        clutter_cls = rng.integers(0, M, n_clutter)
        clutter_feats = (world.prototypes[clutter_cls]
                         + rng.standard_normal((n_clutter, d))
                         * 1.3 * difficulty / np.sqrt(d))
        clutter_boxes = _rand_boxes(rng, n_clutter, dyn["size"])
        # localization noise: some proposals straddle the IoU=0.5 boundary
        jitter = rng.standard_normal((n_obj, 4)) * 0.01
        sloppy = rng.random(n_obj) < 0.25
        jitter[sloppy] = rng.standard_normal((int(sloppy.sum()), 4)) * 0.035
        feats = np.concatenate([feats_obj, clutter_feats])[:n_max]
        pboxes = np.concatenate(
            [np.clip(boxes + jitter, 0, 1), clutter_boxes])[:n_max]
        pcls = np.concatenate([classes, -np.ones(n_clutter, np.int64)])[:n_max]
        n = feats.shape[0]
        pad = n_max - n
        if pad:
            feats = np.concatenate([feats, np.zeros((pad, d))])
            pboxes = np.concatenate([pboxes, np.zeros((pad, 4))])
            pcls = np.concatenate([pcls, -np.ones(pad, np.int64)])
        valid = np.arange(n_max) < n

        relevant = world.relevance[task_id] > 0.5
        keep = relevant[np.clip(classes, 0, M - 1)]
        frames.append(Frame(
            feats.astype(np.float32), pboxes.astype(np.float32),
            pcls.astype(np.int32), valid,
            boxes[keep].astype(np.float32), classes[keep].astype(np.int32)))
    return frames


def edge_windows(world: World, task_id: int, n_windows: int, seed,
                 n_max: int, N_max: int) -> list[Frame]:
    """One camera stream's windows: ``simulate_sequence`` with at most
    ``n_max`` proposals a window, padded to ``N_max`` rows. ``n_max =
    N_max`` is the traffic ``launch/serve.py`` serves (every object and
    clutter proposal kept); a smaller ``n_max`` cuts each window to its
    first ``n_max`` proposals."""
    frames = simulate_sequence(world, task_id, n_windows, seed=seed,
                               n_max=n_max)
    pad = N_max - n_max
    return [dataclasses.replace(
        f, feats=np.pad(f.feats, ((0, pad), (0, 0))),
        boxes=np.pad(f.boxes, ((0, pad), (0, 0))),
        classes=np.pad(f.classes, (0, pad), constant_values=-1),
        valid=np.pad(f.valid, (0, pad))) for f in frames]
