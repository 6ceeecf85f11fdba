from .model_zoo import ModelAPI, decode_inputs_specs, get_api, make_train_batch, train_batch_specs

__all__ = ["ModelAPI", "decode_inputs_specs", "get_api", "make_train_batch",
           "train_batch_specs"]
