"""Train and eval steps (port of ``repro.train``)."""
from repro_torch.train.step import TrainState, make_train_step, make_eval_step  # noqa: F401
