from repro_torch.train.step import (  # noqa: F401
    make_train_step, make_init_fn, TrainStepConfig,
)
