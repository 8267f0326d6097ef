from repro_torch.checkpoint.io import (TRAIN_STATE_VERSION, CheckpointCorruptError,  # noqa: F401
                                       TrainState, fit_tree, list_train_state_dirs,
                                       load_checkpoint, load_latest_train_state,
                                       load_train_state, save_checkpoint,
                                       save_train_state)
