from .mtx import read_mtx, read_mtx_coo, write_mtx
