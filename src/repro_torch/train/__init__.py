from repro_torch.train.train_loop import (  # noqa: F401
    TrainState, init_state, jit_train_step, loss_and_grads, make_compressed_dp_train_step,
    make_train_step,
)
