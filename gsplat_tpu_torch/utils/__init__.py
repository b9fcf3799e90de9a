"""Host-side utilities of ``fit()``: metrics logging and
device-memory estimates."""
