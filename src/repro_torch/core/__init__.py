"""Graph storage, update/sync abstraction and executor of the port."""
