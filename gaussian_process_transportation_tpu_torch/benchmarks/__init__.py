from .multi_frame import MultipleReferenceFramesGPT, ablation_study, compare_methods
from .comparison import run_comparison
from .statistics import mann_whitney_ranking, ranked_boxplot, ranking_report
from .baselines import (
    MultipleReferenceFramesDMP,
    MultipleReferenceFramesTPGMM,
    MultipleReferenceFramesHMM,
    MultipleReferenceFramesKMP,
    MultipleReferenceFramesLE,
)

__all__ = [
    "MultipleReferenceFramesGPT",
    "ablation_study",
    "compare_methods",
    "run_comparison",
    "mann_whitney_ranking",
    "ranked_boxplot",
    "ranking_report",
    "MultipleReferenceFramesDMP",
    "MultipleReferenceFramesTPGMM",
    "MultipleReferenceFramesHMM",
    "MultipleReferenceFramesKMP",
    "MultipleReferenceFramesLE",
]
