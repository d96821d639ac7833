from .matrix_market import load_matrix_market, save_matrix_market

__all__ = ["load_matrix_market", "save_matrix_market"]
