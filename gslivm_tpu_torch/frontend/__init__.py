"""Host-side front end of the port: the voxel-GP map, the synthetic data
source, and the LIVO front end (sensors, ESKF + plane-ICP odometry, VIO,
`livo.LivoFrontend`) and the ROS-bag reader (`rosbag`), own copies of
gslivm_tpu/frontend/*.py; `vision` stands in for the OpenCV calls of the
image path, and `jpeg`, `png` and `imgproc` for those of the camera intake
(CompressedImage decoding, resize, undistortion)."""
