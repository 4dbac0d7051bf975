"""Optional wandb 3D-scene visualization for debugging (the port's copy of
`butd_detr_tpu/utils/visualize.py`).

Rebuild of reference `joint_det_dataset._visualize_scene`
(joint_det_dataset.py:826-892): logs the colored point cloud plus
target / anchor / distractor / other boxes as a wandb Object3D. No-op when
wandb is unavailable or not initialized (the reference gates this behind a
hardcoded `visualize` flag)."""

from typing import Optional, Sequence

import numpy as np

from butd_detr_tpu_torch.data.augment import MEAN_RGB, box2points

_COLORS = {
    "target": [0, 255, 0],
    "anchor": [0, 0, 255],
    "distractor": [0, 255, 255],
    "other": [255, 0, 0],
}


def scene_to_wandb_object(
    point_cloud: np.ndarray,  # (N, >=3); cols 3:6 = mean-centered colors
    all_bboxes: np.ndarray,  # (K, 6) cxcyczwhd
    target_id: int,
    anchor_ids: Sequence[int] = (),
    distractor_ids: Sequence[int] = (),
):
    """Build the wandb.Object3D payload; raises ImportError without wandb."""
    import wandb

    pc = np.array(point_cloud[:, :6], np.float32)
    if pc.shape[1] >= 6:
        pc[:, 3:6] = (pc[:, 3:6] + MEAN_RGB) * 256
    corners = box2points(np.asarray(all_bboxes)[:, :6])

    def boxes(ids, label):
        return [
            {
                "corners": corners[i].tolist(),
                "label": label,
                "color": _COLORS[label],
            }
            for i in ids
        ]

    anchor_ids = [int(i) for i in anchor_ids if int(i) >= 0]
    distractor_ids = [int(i) for i in distractor_ids if int(i) >= 0]
    special = {int(target_id), *anchor_ids, *distractor_ids}
    others = [i for i in range(len(corners)) if i not in special]
    return wandb.Object3D({
        "type": "lidar/beta",
        "points": pc,
        "boxes": np.array(
            boxes([target_id], "target")
            + boxes(anchor_ids, "anchor")
            + boxes(distractor_ids, "distractor")
            + boxes(others, "other")
        ),
    })


def visualize_scene(sample: dict, utterance: Optional[str] = None) -> bool:
    """Log one dataset sample to wandb; returns False if wandb is missing
    or has no active run."""
    try:
        import wandb

        if wandb.run is None:
            return False
        obj = scene_to_wandb_object(
            sample["point_clouds"],
            sample["all_bboxes"],
            sample.get("target_id", 0),
            sample.get("anchor_ids", ()),
            sample.get("distractor_ids", ()),
        )
        wandb.log({
            "ground_truth_point_scene": obj,
            "utterance": wandb.Html(
                utterance or sample.get("utterances", "")
            ),
        })
        return True
    except ImportError:
        return False
