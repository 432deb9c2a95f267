from .fit import (  # noqa: F401
    FitParams,
    fit_transfer_function,
    load_checkpoint,
    make_train_step,
    render_loss,
    save_checkpoint,
)
