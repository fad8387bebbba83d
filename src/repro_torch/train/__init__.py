from .loop import StepMonitor, TrainLoop
from .step import cross_entropy, make_eval_step, make_train_step

__all__ = ["StepMonitor", "TrainLoop", "cross_entropy", "make_eval_step", "make_train_step"]
