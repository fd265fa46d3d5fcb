from .mesh import (batched_rollouts, make_mesh, rollout_safety_stats,
                   sharded_predict_fullmat,
                   trainaxis_sharded_predict_fullmat)

__all__ = ["make_mesh", "batched_rollouts", "rollout_safety_stats",
           "sharded_predict_fullmat",
           "trainaxis_sharded_predict_fullmat"]
