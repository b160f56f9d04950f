"""The native host library: OBJ parsing and the SAH triangle order
(``src/native.cpp``, a copy of raytpu's), built with g++ at first use."""
