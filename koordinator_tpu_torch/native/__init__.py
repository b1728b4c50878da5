"""Native C++ components of the port, built from their sources at first use.

`floor.py` binds the compiled serial scheduling floor (serial_floor.cpp):
the yardstick `vs_compiled_floor` holds kernel 1 against, and the LowNodeLoad
pass's serial floor. `build.py` compiles it, and the C++ sidecar client
(sidecar_client.cpp, with `protoc`-generated messages), into build/native/
at the root of the checkout, keyed by a digest of the sources. Nothing is
built when a module is imported, and a failed build raises with the
compiler's output: no caller falls back to another yardstick.
"""
