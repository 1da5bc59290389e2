from .loop import FaultInjector, TrainLoop, TrainLoopConfig
from .steps import (make_compressed_dp_train_step, make_decode_step, make_eval_step,
                    make_prefill_step, make_train_step, warm_train)

__all__ = ["TrainLoop", "TrainLoopConfig", "FaultInjector", "make_train_step",
           "make_compressed_dp_train_step", "make_eval_step", "warm_train",
           "make_prefill_step", "make_decode_step"]
