from pacmann.utils.platform import backend, enable_compile_cache  # noqa: F401
