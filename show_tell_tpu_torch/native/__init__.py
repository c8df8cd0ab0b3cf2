"""Host-side native code of the port: the JPEG decoder (fastimage.cpp),
built with g++ at first use and loaded with ctypes."""
