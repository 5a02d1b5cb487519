"""k-space metacalibration operations (N <= 512 subset)."""
