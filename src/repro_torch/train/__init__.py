from .loop import TrainLoopConfig, train_loop
from .step import TrainStepConfig, global_grad_norm, reduce_grads
