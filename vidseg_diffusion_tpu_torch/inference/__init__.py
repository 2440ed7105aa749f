"""The sampling API: txt2img, img2img, the SDXL refiner and SVD img2vid."""
