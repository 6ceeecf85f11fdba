from .model_zoo import ModelAPI, get_api, make_train_batch

__all__ = ["ModelAPI", "get_api", "make_train_batch"]
