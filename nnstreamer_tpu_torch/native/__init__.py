"""Host native code: ctypes bindings for the C++ buffer ring."""
