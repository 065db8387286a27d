"""IMU preintegration, the 15-DoF NavState and VINS initialization."""
