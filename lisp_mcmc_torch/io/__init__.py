from .files import file_specs, get_filename, read_file_data

__all__ = ["file_specs", "get_filename", "read_file_data"]
