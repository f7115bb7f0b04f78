from .builder import build_network, load_data_to_device  # noqa: F401
